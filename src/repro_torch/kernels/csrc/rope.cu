// Rotary position embedding (RoPE) of q and k in one launch, forward and
// adjoint (sm_90a), CUDA C++: B7.
//
// Replaces no Pallas kernel. The kernel stands for what XLA fuses under the
// reference's `jax.jit` out of `apply_rope` (src/repro/models/layers.py:44,
// with `rope_frequencies` at :40), which `project_qkv`
// (src/repro/models/attention.py:46-47) calls for q and for k: the f32
// angles position · freq, their cos and sin, and the half-split rotation
//   out1 = x1·cos - x2·sin,  out2 = x1·sin + x2·cos
// of each head's two halves in f32, rounded to x's dtype. The port's eager
// chain (kernels/rope.py `rope_plain`) launches some 17 kernels a tensor.
// The adjoint is the same rotation by the negated angle,
//   dx1 = g1·cos + g2·sin,   dx2 = g2·cos - g1·sin,
// which this kernel computes with sin negated (the mode's `bwd` bit):
// g1·c - g2·(-s) and g1·(-s) + g2·c are those sums exactly.
//
// Bits: every step is the eager chain's, rounded on its own: the position
// converted to f32 as `.float()` converts it (`__ll2float_rn`,
// `__int2float_rn`), the angle `__fmul_rn(pos, freq)` with the freqs
// PyTorch computed (`rope_frequencies`, passed in), `cosf` and `sinf` (the
// precise ones: built without `--use_fast_math`, the functions PyTorch's
// `torch.cos` and `torch.sin` call), each product and each sum by
// `__fmul_rn`, `__fsub_rn`, `__fadd_rn` (no contraction into an fma), one
// rounding to the dtype at the end. So the output equals the eager chain's
// bit for bit.
//
// Layout: q (B, S, Hq, hd) and k (B, S, Hk, hd) read at their (b, s, h)
// strides, the last dim contiguous; positions (B, S) int64 or int32 at
// their strides (the model's `arange(S).expand(B, S)` has a batch stride
// of 0; a decode step's (B, 1) is one position a row); the outputs
// contiguous. A block takes `tb` tokens: its threads first compute the
// tokens' cos and sin for the hd/2 frequencies once into shared memory (a
// sin and a cos an angle, shared by every head of q and of k), then
// rotate the tokens' (head, unit) pairs, four in flight a thread, each
// pair's two halves in 16-byte units (8 bf16 or 4 f32: the `vector` route,
// where hd/2 is whole units and every stride and pointer 16-byte aligned)
// or element by element (`scalar`).
//
// What bounds it on this card: bytes. phi4-mini-3.8b's training shape, q
// (4, 1024, 24, 128) and k (4, 1024, 8, 128) bf16, read and written once:
// 67.1 MB, 0.020 ms at 3.35 TB/s; the angles' sin and cos, 4096 tokens x 64
// frequencies, are ~0.5 M precise evaluations, ~1% of the bytes' time at
// the card's f32 rate. What the design does about it: q and k in one pass,
// each element read and written once in 16-byte units, the trigonometry
// once a token and frequency (not once a head), no tables in device memory.
#include "common.cuh"

namespace {

constexpr int MODE_VECTOR = 1, MODE_DTYPE = 2, MODE_BWD = 4, MODE_POS32 = 8,
              MODE_DEVICE_SHIFT = 8;
constexpr int THREADS = 256;      // a block
constexpr int NI = 4;             // (head, unit) pairs a thread has in flight

struct Args {
  const void* q;
  const void* k;
  const void* pos;
  const float* freqs;
  void* oq;
  void* ok;
  long long B, S;
  long long qsb, qss, qsh, ksb, kss, ksh, psb, pss;
  int Hq, Hk, half, tb;
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int V, bool POS32, bool BWD>
__device__ __forceinline__ void rotate(const Args& a) {
  extern __shared__ float sh[];
  const int half = a.half;
  float* cs = sh;                                    // (tb, half) cos
  float* sn = sh + a.tb * half;                      // (tb, half) sin (negated: BWD)
  long long* tok_b = reinterpret_cast<long long*>(sn + a.tb * half);   // (tb,)
  long long* tok_s = tok_b + a.tb;                                     // (tb,)
  const long long tokens = a.B * a.S;
  const long long tok0 = static_cast<long long>(blockIdx.x) * a.tb;
  const int ntok = static_cast<int>(min(static_cast<long long>(a.tb), tokens - tok0));
  for (int t = threadIdx.x; t < ntok; t += THREADS) {
    const long long tok = tok0 + t, b = tok / a.S;
    tok_b[t] = b;
    tok_s[t] = tok - b * a.S;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ntok * half; i += THREADS) {
    const int t = i / half, f = i - t * half;
    const long long off = tok_b[t] * a.psb + tok_s[t] * a.pss;
    const float p = POS32 ? __int2float_rn(static_cast<const int*>(a.pos)[off])
                          : __ll2float_rn(static_cast<const long long*>(a.pos)[off]);
    const float ang = __fmul_rn(p, a.freqs[f]);
    cs[i] = cosf(ang);
    const float s = sinf(ang);
    sn[i] = BWD ? -s : s;
  }
  __syncthreads();
  const int units = half / V, heads = a.Hq + a.Hk;
  const int per_tok = heads * units, items = ntok * per_tok;
  const long long hd = 2LL * half;
  for (int base = threadIdx.x; base < items; base += THREADS * NI) {
    float x1[NI][V], x2[NI][V];
    T* dst[NI];
    int at[NI];
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int it = base + n * THREADS;
      dst[n] = nullptr;
      if (it >= items) continue;
      const int t = it / per_tok, r = it - t * per_tok, h = r / units, u = r - h * units;
      const long long b = tok_b[t], s = tok_s[t], tok = tok0 + t;
      const T* src;
      if (h < a.Hq) {
        src = static_cast<const T*>(a.q) + b * a.qsb + s * a.qss + h * a.qsh;
        dst[n] = static_cast<T*>(a.oq) + (tok * a.Hq + h) * hd;
      } else {
        const int hk = h - a.Hq;
        src = static_cast<const T*>(a.k) + b * a.ksb + s * a.kss + hk * a.ksh;
        dst[n] = static_cast<T*>(a.ok) + (tok * a.Hk + hk) * hd;
      }
      src += u * V;
      dst[n] += u * V;
      load_unit<T, V>(src, x1[n]);
      load_unit<T, V>(src + half, x2[n]);
      at[n] = t * half + u * V;
    }
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      if (!dst[n]) continue;
      float o1[V], o2[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float c = cs[at[n] + i], s = sn[at[n] + i];
        o1[i] = __fsub_rn(__fmul_rn(x1[n][i], c), __fmul_rn(x2[n][i], s));
        o2[i] = __fadd_rn(__fmul_rn(x1[n][i], s), __fmul_rn(x2[n][i], c));
      }
      store_unit<T, V>(dst[n], o1);
      store_unit<T, V>(dst[n] + half, o2);
    }
  }
}

// the forward and the adjoint under their own names (a profile tells them
// apart by name)
template <typename T, int V, bool POS32>
__global__ void __launch_bounds__(THREADS) rope_qk_fwd_kernel(Args a) {
  rotate<T, V, POS32, false>(a);
}

template <typename T, int V, bool POS32>
__global__ void __launch_bounds__(THREADS) rope_qk_bwd_kernel(Args a) {
  rotate<T, V, POS32, true>(a);
}

template <typename T, int V>
const void* pick(bool pos32, bool bwd) {
  if (pos32) return bwd ? (const void*)rope_qk_bwd_kernel<T, V, true>
                        : (const void*)rope_qk_fwd_kernel<T, V, true>;
  return bwd ? (const void*)rope_qk_bwd_kernel<T, V, false>
             : (const void*)rope_qk_fwd_kernel<T, V, false>;
}

const void* kernel_for(int mode) {
  const bool vector = mode & MODE_VECTOR, bf16 = mode & MODE_DTYPE, bwd = mode & MODE_BWD,
             pos32 = mode & MODE_POS32;
  if (bf16) return vector ? pick<__nv_bfloat16, 8>(pos32, bwd) : pick<__nv_bfloat16, 1>(pos32, bwd);
  return vector ? pick<float, 4>(pos32, bwd) : pick<float, 1>(pos32, bwd);
}

}  // namespace

// Shared memory a block of `tb` tokens takes at half = hd / 2.
extern "C" long long rope_qk_smem(int tb, int half) {
  return 2LL * tb * half * sizeof(float) + 2LL * tb * sizeof(long long);
}

// The rotation. mode: bit 0 the vector route, bit 1 bf16 (else f32), bit 2
// the adjoint (sin negated), bit 3 int32 positions (else int64), the
// device from bit 8. q, k and their outputs oq, ok as the header says (k
// and ok null where Hk is 0); strides: q's (b, s, h), k's (b, s, h), the
// positions' (b, s), in elements; freqs (half,) f32; tb tokens a block.
extern "C" int rope_qk(int mode, const void* q, const void* k, const void* pos,
                       const float* freqs, void* oq, void* ok, long long B, long long S, int Hq,
                       int Hk, int half, const long long* strides, int tb, void* stream) {
  const bool vector = mode & MODE_VECTOR, bf16 = mode & MODE_DTYPE;
  const int esize = bf16 ? 2 : 4, v = vector ? 16 / esize : 1;
  if (B < 0 || S < 0 || Hq < 1 || Hk < 0 || half < 1 || half % v != 0 || tb < 1 || !strides ||
      (B * S > 0 && (!q || !pos || !freqs || !oq || (Hk > 0 && (!k || !ok)))))
    return cudaErrorInvalidValue;
  const long long tokens = B * S;
  if (tokens == 0) return cudaSuccess;
  if (static_cast<long long>(tb) * (Hq + Hk) * (half / v) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (vector) {
    if (!aligned16(q) || !aligned16(oq) || (Hk > 0 && (!aligned16(k) || !aligned16(ok))))
      return cudaErrorInvalidValue;
    for (int i = 0; i < 6; ++i)
      if ((strides[i] * esize) % 16 != 0) return cudaErrorInvalidValue;
  }
  Args a = {};
  a.q = q; a.k = k; a.pos = pos; a.freqs = freqs; a.oq = oq; a.ok = ok; a.B = B; a.S = S;
  a.qsb = strides[0]; a.qss = strides[1]; a.qsh = strides[2];
  a.ksb = strides[3]; a.kss = strides[4]; a.ksh = strides[5];
  a.psb = strides[6]; a.pss = strides[7];
  a.Hq = Hq; a.Hk = Hk; a.half = half; a.tb = tb;
  const long long blocks = (tokens + tb - 1) / tb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(rope_qk_smem(tb, half));
  OnDevice on(mode >> MODE_DEVICE_SHIFT);
  const void* fn = kernel_for(mode);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  void* params[] = {&a};
  if (err == cudaSuccess)
    err = cudaLaunchKernel(fn, dim3(static_cast<unsigned>(blocks)), dim3(THREADS), params, smem,
                           static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The registers a thread and the local memory (stack frame, spills
// included) of the kernel for mode's dtype, route, direction and
// positions' type, from the runtime.
extern "C" int rope_qk_attributes(int mode, int* regs, int* local_bytes) {
  if (!regs || !local_bytes) return cudaErrorInvalidValue;
  OnDevice on(mode >> MODE_DEVICE_SHIFT);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel_for(mode));
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return err;
}

extern "C" const char* rope_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
