// The compiled batch tier's event loop for Hopper (sm_90a): one warp per lane.
//
// Replaces the XLA-compiled jax.lax.while_loop of
// src/repro/core/batchsim_compiled.py (_advance_factory, :117). A batch holds
// W independent scheduler simulations (lanes) of one scenario; each lane is a
// discrete-event loop over request arrivals, worker completions and the drain
// of its pending deliveries, ordered by the (time, seq) key of the numpy
// BatchSimulator. The reference advances all lanes in lock-step, one event per
// lane per iteration, as masked full-width updates. Lanes never interact, so
// here one warp runs one lane's whole loop to quiescence, and the batch is one
// launch.
//
// What bounds it: latency. A lane is one dependent chain of events: each picks
// its successor from the lane's frontier (C = G + P + 1 columns), then runs one
// handler whose steps depend on each other. The bytes (the packed tables in,
// the outputs out, the rings and pending counters) and the compares are small:
// the card could move and do them in under a microsecond at the sweep's widest
// batch. What is left is the chain: per event, the frontier's argmin (a
// __syncwarp, one shared-memory load a thread, two warp-wide reductions, a
// ballot and a shuffle), then thread 0's handler, a chain of shared-memory
// accesses and loads of the lane's read-only tables, pending counters and
// rings (L1, else L2), in 64-bit integer and fp64 arithmetic.
//
// The design:
// - one warp per lane, LANES_PER_BLOCK lanes a block. Two warps sit on two of
//   the SM's four schedulers and need no barrier but their own __syncwarp; an
//   SM holds at most 32 blocks, so two warps a block let it hold its full 64
//   warps (8,448 lanes in one wave on 132 SMs), while the sweep's widths (48
//   padded lanes and fewer) still spread over 24 SMs (one warp a block times
//   the same);
// - warp-uniform control: every thread gets the frontier's minimum from a
//   warp reduction on (time, seq, column), a full tie going to the lowest
//   column as the serial scan does, so the loop condition, the event and its
//   handler are the same on all 32 threads. The time is reduced as an
//   order-preserving 64-bit key by two redux.sync (__reduce_min_sync) of its
//   halves; the seq and the column only where two columns share the time (a
//   butterfly of shuffles on (time, seq, column) makes the kernel 22% slower,
//   thread 0's serial scan and a broadcast 7%);
// - work without an order is spread over the warp: the argmin, the S pending
//   counters of an arriving request (one word a thread, coalesced), the
//   throttle and dropout windows a delivery matches and the first non-empty
//   FIFO class of a finished worker (by ballot; thread 0's scan: 3% slower),
//   and the initialisation of the outputs and the state;
// - work with an order stays on thread 0, in the reference's order: sequence
//   numbers, the dispatch token before its task, roots and successors in
//   order, ring pushes and pops, the busy sums, the matching throttle factors
//   multiplied in index order and the first matching dropout;
// - the lane's mutable event state lives in shared memory (shared_words: the
//   frontier's times and seqs, busy, src_rid, idle, end_g, end_rr, the delivery
//   ring, the FIFO heads and tails; 69 words, 552 B, at the sweep's G 3, P 3,
//   NP 6), its counters (seq, tok, zpos, fpos, del_n, overflow) in thread 0's
//   registers, the read-only tables come through the read-only path (__ldg),
//   and the pending counters (R x S int32) and the (pid, class) FIFO rings (P
//   x NP x CAP words) stay in global memory, each lane's contiguous. Keeping
//   the per-request outputs in shared memory gains nothing (+0.7%); staging
//   the small read-only tables there gains 2.2% but would tie a block's
//   shared memory to S, so it is not done.
//
// ptxas -v (sm_90a, CUDA 12.9): 154 registers, no stack, no spill (the
// thread-per-lane kernel below: 238, no spill). Measured on an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py's kernel_check and
// examples/batchsim_probe_torch.py; PERF.md §6): sweep scenario 1's widest
// batch (48 padded lanes, 2,542 events on the longest) in 1.84-1.87 ms, 0.73
// us or ~1,450 cycles an event of the longest lane, against 6.33-6.39 ms for
// the thread-per-lane kernel timed in turns; 1.86-1.95 ms from 16 to 1,024
// lanes. Of an event, the argmin takes ~450 cycles; an arrival's handler
// ~1,670, a completion's ~990, a drain's ~890.
//
// Left for later: a persistent grid that hands a finished warp the next lane
// (uneven lanes keep an SM slot until their longest warp ends), and several
// α*-search rounds in one launch (each round is one launch now, paced by the
// host's GA).
//
// The thread-per-lane kernel this design replaced stays below
// (per_thread::batchsim_advance_thread_kernel, entry batchsim_advance_thread)
// as a yardstick for timing; batchsim_advance never launches it.
//
// Numbers: every float is IEEE double with the reference's operation order,
// through __dadd_rn, __dsub_rn and __dmul_rn, which the compiler never
// contracts into a fused multiply-add. The noise and straggler multipliers
// come from the host (math.exp and the Pareto expression there), so the loop
// calls no math library. Sequence numbers are taken at push time, and the
// dispatch token before its task, as in the reference's release(), so each
// FIFO ring's order is the numpy tier's packed-key order.
//
// Per lane it also writes whether a push found its ring full (pos - head >=
// CAP), the events run and the tasks pushed into its rings. A full ring or a
// lane at the iteration cap means the loop is wrong: the host raises.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

typedef long long i64;

// header words of the packed buffer (repro_torch/kernels/batchsim_advance.py: HEADER)
enum Header {
  H_W, H_G, H_P, H_NP, H_CAP, H_S, H_NR, H_J, H_DM, H_ZC, H_FC, H_T, H_D,
  H_ANY_NOISE, H_ANY_FAULT, H_ANY_STRAG, H_ANY_DISPATCH, H_ITERCAP, H_COUNT
};
// tables after the header, one offset word each (batchsim_advance.py: TABLES)
enum Table {
  T_ARRTAB, T_HORIZON, T_NR, T_PROC_OF, T_PRIO_OF, T_EXEC_V, T_QUANT_V, T_COMM_V, T_TOTAL_V,
  T_DEP_CNT, T_SUCC_PAD, T_SUCC_CNT, T_ROOTS, T_ROOTS_N, T_OVERLAP, T_DISPATCH_OV,
  T_DISPATCH_PID, T_DISPATCH_KNOWN, T_NOISY, T_SIGMA_POS, T_EMULT, T_FAULTED, T_STRAG_ON,
  T_STRAG_TAB, T_THR_PID, T_THR_T0, T_THR_T1, T_THR_FAC, T_DROP_PID, T_DROP_T0, T_DROP_T1,
  T_IDLE0, T_COUNT
};

static constexpr i64 BIGSEQ = 1LL << 62;
static constexpr i64 M21 = (1LL << 21) - 1;
static constexpr unsigned FULL = 0xffffffffu;
// lanes (= warps) a block (batchsim_advance.py: LANES_PER_BLOCK)
static constexpr int LANES_PER_BLOCK = 2;

// One lane's shared words: times (C), seqs (C), busy (P), src_rid (G), idle (P),
// end_g (P), end_rr (P), the delivery ring (P + 1), FIFO heads and tails (P x NP)
// (batchsim_advance.py: shared_words).
__host__ __device__ inline i64 shared_words(i64 G, i64 P, i64 NP) {
  const i64 C = G + P + 1;
  return 2 * C + P + G + 3 * P + (P + 1) + 2 * P * NP;
}

// Scratch in 64-bit words: the pending counters (W x R x S int32), then the
// FIFO rings (W x P x NP x CAP).
__host__ __device__ inline i64 pend_words(i64 W, i64 R, i64 S) { return (W * R * S + 1) / 2; }

__device__ __forceinline__ double inf() { return __longlong_as_double(0x7ff0000000000000LL); }

namespace warp_lane {

struct Lane {
  int G, P, NP, S, NR, J, DM, ZC, FC, T, D, C, K;
  int lane;   // this thread's index in the warp
  bool lead;  // thread 0, which runs the ordered work
  i64 CAP;
  bool any_noise, any_fault, any_strag, any_dispatch;
  // this lane's rows of the read-only tables
  const double *arrtab, *exec_v, *quant_v, *comm_v, *total_v, *emult, *strag_tab;
  const double *thr_t0, *thr_t1, *thr_fac, *drop_t0, *drop_t1;
  const i64 *proc_of, *prio_of, *dep_cnt, *succ_pad, *succ_cnt, *roots, *roots_n;
  const i64 *sigma_pos, *thr_pid, *drop_pid;
  i64 nr, dispatch_pid;
  double horizon, dispatch_ov;
  bool overlap, dispatch_known, noisy, faulted, strag_on;
  // the mutable event state, in shared memory
  double *times, *busy;
  i64 *seqs, *src_rid, *idle, *end_g, *end_rr, *del, *fhead, *ftail;
  // global: the pending counters (R, S), the rings (P, NP, CAP), the outputs
  int* pend;
  i64* ring;
  double *arrival, *first_start, *last_finish;
  i64* done;
  // thread 0's counters (the other threads' copies are never read)
  i64 seq, tok, zpos, fpos;
  int del_n;
  bool overflow;
};

// A double's bits, mapped so that unsigned order is the double's order (the
// frontier holds no NaN; a time is never -0: it is 0, +inf or a sum of a
// time and a duration >= 0).
__device__ __forceinline__ unsigned long long ordered(double t) {
  const long long b = __double_as_longlong(t);
  return b < 0 ? ~(unsigned long long)b : (unsigned long long)b | 0x8000000000000000ull;
}

// The least 64-bit value over the warp, on every thread: two warp-wide
// reductions (redux.sync) of its 32-bit halves.
__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  const unsigned hi = (unsigned)(v >> 32);
  const unsigned mhi = __reduce_min_sync(FULL, hi);
  const unsigned mlo = __reduce_min_sync(FULL, hi == mhi ? (unsigned)v : 0xffffffffu);
  return ((unsigned long long)mhi << 32) | mlo;
}

// The frontier's earliest (time, seq), the lowest column on a full tie, on
// every thread of the warp. A thread holds column lane (and lane + 32, ...);
// the warp reduces the time, then, only where two columns share it, the seq
// and the column.
__device__ __forceinline__ void frontier_min(const Lane& L, double& tmin, int& ci) {
  double t = inf();
  i64 s = LLONG_MAX;
  int c = INT_MAX;
  for (int k = L.lane; k < L.C; k += 32) {
    const double tk = L.times[k];
    const i64 sk = L.seqs[k];
    if (tk < t || (tk == t && sk < s)) {
      t = tk;
      s = sk;
      c = k;
    }
  }
  const unsigned long long key = c != INT_MAX ? ordered(t) : ~0ull;
  const unsigned long long m = warp_min(key);
  const bool at = c != INT_MAX && key == m;
  const unsigned bits = __ballot_sync(FULL, at);
  if (__popc(bits) > 1) {
    const unsigned long long sm = warp_min(at ? (unsigned long long)s : ~0ull);
    const bool first = at && (unsigned long long)s == sm;
    ci = (int)__reduce_min_sync(FULL, first ? (unsigned)c : 0xffffffffu);
  } else {
    ci = __shfl_sync(FULL, c, __ffs(bits) - 1);
  }
  tmin = __longlong_as_double((long long)(m >> 63 ? m ^ 0x8000000000000000ull : ~m));
}

// Thread 0 from here to drain(), unless a comment says otherwise.
__device__ __forceinline__ void append_deliver(Lane& L, int pid, i64 g, i64 rr, double t) {
  if (L.del_n >= L.K) {  // impossible: a pid waits in the ring at most once
    L.overflow = true;
    return;
  }
  L.idle[pid] = 0;
  L.del[L.del_n] = ((i64)(pid + 1) << 42) | ((g + 1) << 21) | (rr + 1);
  if (L.del_n == 0) {
    L.times[L.C - 1] = t;
    L.seqs[L.C - 1] = L.seq;
  }
  ++L.del_n;
  ++L.seq;
}

__device__ __forceinline__ void queue_push(Lane& L, int pid, int cls, i64 g, i64 rr) {
  const int q = pid * L.NP + cls;
  const i64 pos = L.ftail[q], head = L.fhead[q];
  if (pos - head >= L.CAP) {
    L.overflow = true;
    return;
  }
  L.ring[(i64)q * L.CAP + (pos & (L.CAP - 1))] = ((g + 1) << 21) | (rr + 1);
  L.ftail[q] = pos + 1;
}

// The reference's release(): the dispatch token first, then the task.
__device__ __forceinline__ void release(Lane& L, i64 g, i64 rr, double t) {
  if (L.any_dispatch && L.dispatch_known) {
    const int dp = (int)L.dispatch_pid;
    if (L.idle[dp]) append_deliver(L, dp, -1, -1, t);
    else ++L.tok;  // tokens queue only on dispatch_pid: their FIFO is a counter
  }
  const int pid = (int)__ldg(L.proc_of + g);
  if (L.idle[pid]) append_deliver(L, pid, g, rr, t);
  else queue_push(L, pid, (int)__ldg(L.prio_of + g), g, rr);
}


// An arrival's first half: a first arrival after 0 re-arms the source (-1),
// else the request's row.
__device__ __forceinline__ i64 arrival_request(Lane& L, int gid, double t) {
  const i64 rid = L.src_rid[gid];
  const double a0 = __ldg(L.arrtab + (i64)gid * L.NR);
  if (rid == 0 && a0 > t) {
    L.times[gid] = __dadd_rn(t, __dsub_rn(a0, t));
    L.seqs[gid] = L.seq++;
    return -1;
  }
  const i64 rr = (i64)gid * L.NR + rid;
  L.arrival[rr] = t;
  return rr;
}

// An arrival's second half, after the warp set its pending counters: the
// roots in order, then the source's next arrival.
__device__ __forceinline__ void arrival_release(Lane& L, int gid, i64 rr, double t) {
  const int nroots = (int)__ldg(L.roots_n + gid);
  for (int j = 0; j < nroots; ++j) release(L, __ldg(L.roots + (i64)gid * L.J + j), rr, t);
  const i64 nrid = rr - (i64)gid * L.NR + 1;
  if (nrid < L.nr) {
    const double next = __ldg(L.arrtab + (i64)gid * L.NR + nrid);
    L.times[gid] = __dadd_rn(t, __dsub_rn(next, t));
    L.seqs[gid] = L.seq++;
    L.src_rid[gid] = nrid;
  } else {
    L.times[gid] = inf();
    L.seqs[gid] = BIGSEQ;
  }
}

__device__ __forceinline__ void on_completion(Lane& L, int pid, double t) {
  const i64 g = L.end_g[pid], rr = L.end_rr[pid];
  if (g >= 0) {  // a dispatch token's completion carries no task
    L.done[rr] += 1;
    if (t > L.last_finish[rr]) L.last_finish[rr] = t;
    int* pend = L.pend + rr * L.S;
    const int nsucc = (int)__ldg(L.succ_cnt + g);
    for (int j = 0; j < nsucc; ++j) {
      const i64 sj = __ldg(L.succ_pad + g * L.DM + j);
      if (--pend[sj] == 0) release(L, sj, rr, t);
    }
  }
  L.times[L.G + pid] = inf();
  L.seqs[L.G + pid] = BIGSEQ;
  L.end_g[pid] = -2;
}

// The whole warp, after on_completion: the worker takes a queued dispatch
// token, else the head of its first non-empty priority FIFO, else goes idle.
// The warp finds that FIFO by ballot over the classes; thread 0 pops it.
__device__ __forceinline__ void pull_next(Lane& L, int pid, double t) {
  __syncwarp();  // thread 0's pushes, seen by every thread
  int cls = -1;
  for (int base = 0; base < L.NP && cls < 0; base += 32) {
    const int k = base + L.lane, q = pid * L.NP + k;
    const unsigned bits = __ballot_sync(FULL, k < L.NP && L.fhead[q] < L.ftail[q]);
    if (bits) cls = base + __ffs(bits) - 1;
  }
  if (!L.lead) return;
  if (L.any_dispatch && pid == L.dispatch_pid && L.tok > 0) {
    --L.tok;
    append_deliver(L, pid, -1, -1, t);
  } else if (cls >= 0) {
    const int q = pid * L.NP + cls;
    const i64 head = L.fhead[q];
    const i64 v = L.ring[(i64)q * L.CAP + (head & (L.CAP - 1))];
    L.fhead[q] = head + 1;
    append_deliver(L, pid, ((v >> 21) & M21) - 1, (v & M21) - 1, t);
  } else {
    L.idle[pid] = 1;
  }
}

// The whole warp. Every pending delivery shares the drain's timestamp and
// precedes all other events, so the ring drains in slot (= seq) order; the
// ring's slots were written before the loop's __syncwarp, so every thread
// reads them.
__device__ __forceinline__ void drain(Lane& L, double t) {
  const int n = __shfl_sync(FULL, L.del_n, 0);
  for (int k = 0; k < n; ++k) {
    const i64 v = L.del[k];
    const int pid = (int)((v >> 42) - 1);
    const i64 g = ((v >> 21) & M21) - 1, rr = (v & M21) - 1;
    const int col = L.G + pid;
    if (g < 0) {  // dispatch token: the Coordinator's load on dispatch_pid
      if (L.lead) {
        L.busy[pid] = __dadd_rn(L.busy[pid], L.dispatch_ov);
        L.times[col] = __dadd_rn(t, L.dispatch_ov);
        L.seqs[col] = L.seq++;
        L.end_g[pid] = -1;
      }
      continue;
    }
    double exec_t = 0.0, total = 0.0, cm = 0.0;
    if (L.lead) {
      exec_t = __ldg(L.exec_v + g);
      total = __ldg(L.total_v + g);
      cm = L.overlap ? 0.0 : __ldg(L.comm_v + g);
      if (L.any_noise && L.noisy && __ldg(L.sigma_pos + pid)) {
        const i64 z = L.zpos < L.ZC - 1 ? L.zpos : L.ZC - 1;
        ++L.zpos;
        const double et = __dmul_rn(exec_t, __ldg(L.emult + z * L.P + pid));
        // the scalar loop's order: exec + quant + (0 | comm)
        total = __dadd_rn(__dadd_rn(et, __ldg(L.quant_v + g)), cm);
        exec_t = et;
      }
    }
    if (L.any_fault && L.faulted) {
      double ex_f = exec_t;
      if (L.lead && L.any_strag && L.strag_on) {  // one straggler draw per delivery
        const i64 f = L.fpos < L.FC - 1 ? L.fpos : L.FC - 1;
        ++L.fpos;
        ex_f = __dmul_rn(ex_f, __ldg(L.strag_tab + f));
      }
      // the windows a delivery matches, 32 a ballot; thread 0 multiplies the
      // throttle factors in index order, and the first dropout wins
      for (int base = 0; base < L.T; base += 32) {
        const int ti = base + L.lane;
        const bool hit = ti < L.T && __ldg(L.thr_pid + ti) == pid && __ldg(L.thr_t0 + ti) <= t &&
                         t < __ldg(L.thr_t1 + ti);
        unsigned bits = __ballot_sync(FULL, hit);
        if (L.lead)
          for (; bits; bits &= bits - 1)
            ex_f = __dmul_rn(ex_f, __ldg(L.thr_fac + base + __ffs(bits) - 1));
      }
      double stall = 0.0;
      for (int base = 0; base < L.D; base += 32) {
        const int di = base + L.lane;
        const bool hit = di < L.D && __ldg(L.drop_pid + di) == pid && __ldg(L.drop_t0 + di) <= t &&
                         t < __ldg(L.drop_t1 + di);
        const unsigned bits = __ballot_sync(FULL, hit);
        if (bits) {
          stall = __dsub_rn(__ldg(L.drop_t1 + base + __ffs(bits) - 1), t);
          break;
        }
      }
      if (L.lead) {
        double tt = __dadd_rn(__dadd_rn(ex_f, __ldg(L.quant_v + g)), cm);
        if (stall > 0.0) tt = __dadd_rn(stall, tt);
        total = tt;
      }
    }
    if (L.lead) {
      if (t < L.first_start[rr]) L.first_start[rr] = t;
      // a permanent dropout's stall is infinite: its completion never fires
      if (isfinite(total)) L.busy[pid] = __dadd_rn(L.busy[pid], total);
      L.times[col] = __dadd_rn(t, total);
      L.seqs[col] = L.seq++;
      L.end_g[pid] = g;
      L.end_rr[pid] = rr;
    }
  }
  if (L.lead) {
    L.del_n = 0;
    L.times[L.C - 1] = inf();
    L.seqs[L.C - 1] = BIGSEQ;
  }
}

__global__ void __launch_bounds__(32 * LANES_PER_BLOCK)
    batchsim_advance_kernel(const i64* __restrict__ tab, i64* __restrict__ out,
                            i64* __restrict__ scratch) {
  extern __shared__ __align__(16) i64 smem[];
  const i64 W = __ldg(tab + H_W);
  const int warp = (int)(threadIdx.x >> 5);
  const i64 lane = (i64)blockIdx.x * LANES_PER_BLOCK + warp;
  if (lane >= W) return;
  Lane L;
  L.lane = (int)(threadIdx.x & 31);
  L.lead = L.lane == 0;
  L.G = (int)__ldg(tab + H_G); L.P = (int)__ldg(tab + H_P); L.NP = (int)__ldg(tab + H_NP);
  L.CAP = __ldg(tab + H_CAP); L.S = (int)__ldg(tab + H_S); L.NR = (int)__ldg(tab + H_NR);
  L.J = (int)__ldg(tab + H_J); L.DM = (int)__ldg(tab + H_DM); L.ZC = (int)__ldg(tab + H_ZC);
  L.FC = (int)__ldg(tab + H_FC); L.T = (int)__ldg(tab + H_T); L.D = (int)__ldg(tab + H_D);
  L.any_noise = __ldg(tab + H_ANY_NOISE) != 0; L.any_fault = __ldg(tab + H_ANY_FAULT) != 0;
  L.any_strag = __ldg(tab + H_ANY_STRAG) != 0;
  L.any_dispatch = __ldg(tab + H_ANY_DISPATCH) != 0;
  const i64 itercap = __ldg(tab + H_ITERCAP);
  L.C = L.G + L.P + 1;
  L.K = L.P + 1;
  const i64 R = (i64)L.G * L.NR;
  const i64* off = tab + H_COUNT;
  auto I = [&](int t, i64 row) { return tab + __ldg(off + t) + lane * row; };
  auto F = [&](int t, i64 row) {
    return reinterpret_cast<const double*>(tab + __ldg(off + t)) + lane * row;
  };
  L.arrtab = F(T_ARRTAB, R);
  L.horizon = __ldg(F(T_HORIZON, 1));
  L.nr = __ldg(I(T_NR, 1));
  L.proc_of = I(T_PROC_OF, L.S); L.prio_of = I(T_PRIO_OF, L.S);
  L.exec_v = F(T_EXEC_V, L.S); L.quant_v = F(T_QUANT_V, L.S);
  L.comm_v = F(T_COMM_V, L.S); L.total_v = F(T_TOTAL_V, L.S);
  L.dep_cnt = I(T_DEP_CNT, L.S); L.succ_pad = I(T_SUCC_PAD, (i64)L.S * L.DM);
  L.succ_cnt = I(T_SUCC_CNT, L.S); L.roots = I(T_ROOTS, (i64)L.G * L.J);
  L.roots_n = I(T_ROOTS_N, L.G);
  L.overlap = __ldg(I(T_OVERLAP, 1)) != 0;
  L.dispatch_ov = __ldg(F(T_DISPATCH_OV, 1));
  L.dispatch_pid = __ldg(I(T_DISPATCH_PID, 1));
  L.dispatch_known = __ldg(I(T_DISPATCH_KNOWN, 1)) != 0;
  L.noisy = __ldg(I(T_NOISY, 1)) != 0;
  L.sigma_pos = I(T_SIGMA_POS, L.P);
  L.emult = F(T_EMULT, (i64)L.ZC * L.P);
  L.faulted = __ldg(I(T_FAULTED, 1)) != 0;
  L.strag_on = __ldg(I(T_STRAG_ON, 1)) != 0;
  L.strag_tab = F(T_STRAG_TAB, L.FC);
  L.thr_pid = I(T_THR_PID, L.T); L.thr_t0 = F(T_THR_T0, L.T);
  L.thr_t1 = F(T_THR_T1, L.T); L.thr_fac = F(T_THR_FAC, L.T);
  L.drop_pid = I(T_DROP_PID, L.D); L.drop_t0 = F(T_DROP_T0, L.D);
  L.drop_t1 = F(T_DROP_T1, L.D);
  const i64* idle0 = tab + __ldg(off + T_IDLE0);

  // outputs: arrival, first_start, last_finish, done (W, R); busy (W, P);
  // overflow, iters, pushes (W)
  const i64 WR = W * R;
  double* fout = reinterpret_cast<double*>(out);
  L.arrival = fout + lane * R;
  L.first_start = fout + WR + lane * R;
  L.last_finish = fout + 2 * WR + lane * R;
  L.done = out + 3 * WR + lane * R;
  double* busy_out = fout + 4 * WR + lane * L.P;
  i64* overflow_out = out + 4 * WR + W * L.P;
  i64* iters_out = overflow_out + W;
  i64* pushes_out = iters_out + W;

  // shared: this warp's words; scratch: the pending counters, then the rings
  i64* sh = smem + warp * shared_words(L.G, L.P, L.NP);
  L.times = reinterpret_cast<double*>(sh);
  L.seqs = sh + L.C;
  L.busy = reinterpret_cast<double*>(sh + 2 * L.C);
  L.src_rid = sh + 2 * L.C + L.P;
  L.idle = L.src_rid + L.G;
  L.end_g = L.idle + L.P;
  L.end_rr = L.end_g + L.P;
  L.del = L.end_rr + L.P;
  L.fhead = L.del + L.K;
  L.ftail = L.fhead + L.P * L.NP;
  L.pend = reinterpret_cast<int*>(scratch) + lane * R * L.S;
  L.ring = scratch + pend_words(W, R, L.S) + lane * (i64)L.P * L.NP * L.CAP;

  const double INF = inf();
  for (int c = L.lane; c < L.C; c += 32) {
    L.times[c] = c < L.G ? 0.0 : INF;
    L.seqs[c] = c < L.G ? (i64)c : BIGSEQ;
  }
  for (int g = L.lane; g < L.G; g += 32) L.src_rid[g] = 0;
  for (int p = L.lane; p < L.P; p += 32) {
    L.idle[p] = __ldg(idle0 + p);
    L.end_g[p] = -2;
    L.end_rr[p] = -1;
    L.busy[p] = 0.0;
  }
  for (int q = L.lane; q < L.P * L.NP; q += 32) {
    L.fhead[q] = 0;
    L.ftail[q] = 0;
  }
  for (i64 r = L.lane; r < R; r += 32) {
    L.arrival[r] = 0.0;
    L.first_start[r] = INF;
    L.last_finish[r] = 0.0;
    L.done[r] = 0;
  }
  L.seq = L.G;
  L.tok = L.zpos = L.fpos = 0;
  L.del_n = 0;
  L.overflow = false;

  i64 it = 0;
  while (it < itercap) {
    __syncwarp();  // thread 0's writes of the last event, seen by every thread
    double tmin;
    int ci;
    frontier_min(L, tmin, ci);
    if (!(tmin <= L.horizon)) break;
    if (ci < L.G) {
      i64 rr = L.lead ? arrival_request(L, ci, tmin) : 0;
      rr = __shfl_sync(FULL, rr, 0);
      if (rr >= 0) {
        int* pend = L.pend + rr * L.S;  // read by thread 0 after the next __syncwarp
        for (int s = L.lane; s < L.S; s += 32) pend[s] = (int)__ldg(L.dep_cnt + s);
        if (L.lead) arrival_release(L, ci, rr, tmin);
      }
    } else if (ci < L.G + L.P) {
      if (L.lead) on_completion(L, ci - L.G, tmin);
      pull_next(L, ci - L.G, tmin);
    } else {
      drain(L, tmin);
    }
    ++it;
    if (__shfl_sync(FULL, (int)L.overflow, 0)) break;
  }
  __syncwarp();
  for (int p = L.lane; p < L.P; p += 32) busy_out[p] = L.busy[p];
  i64 pushes = 0;
  for (int q = L.lane; q < L.P * L.NP; q += 32) pushes += L.ftail[q];
  for (int o = 16; o > 0; o >>= 1) pushes += __shfl_xor_sync(FULL, pushes, o);
  if (L.lead) {
    overflow_out[lane] = L.overflow ? 1 : 0;
    iters_out[lane] = it;
    pushes_out[lane] = pushes;
  }
}

}  // namespace warp_lane

// The thread-per-lane kernel the design above replaced: one thread runs one
// lane's loop, the state lane-minor in global memory. Kept only to be timed
// beside the warp-per-lane kernel (entry batchsim_advance_thread).
namespace per_thread {

// Per-lane scratch words, lane-minor: times (C), seqs (C), src_rid (G), idle (P),
// end_g (P), end_rr (P), the delivery ring (P + 1), FIFO heads and tails (P x NP).
__host__ __device__ inline i64 state_words(i64 G, i64 P, i64 NP) {
  const i64 C = G + P + 1;
  return 2 * C + G + 3 * P + (P + 1) + 2 * P * NP;
}

struct Lane {
  int G, P, NP, CAP, S, NR, J, DM, ZC, FC, T, D, C, K;
  i64 W;  // the stride of the lane-minor state
  // this lane's rows of the tables
  const double *arrtab, *exec_v, *quant_v, *comm_v, *total_v, *emult, *strag_tab;
  const double *thr_t0, *thr_t1, *thr_fac, *drop_t0, *drop_t1;
  const i64 *proc_of, *prio_of, *dep_cnt, *succ_pad, *succ_cnt, *roots, *roots_n;
  const i64 *sigma_pos, *thr_pid, *drop_pid;
  i64 nr, dispatch_pid;
  double horizon, dispatch_ov;
  bool overlap, dispatch_known, noisy, faulted, strag_on;
  bool any_noise, any_fault, any_strag, any_dispatch;
  // state: lane-minor arrays (element i at [i * W]), then registers
  double* times;
  i64 *seqs, *src_rid, *idle, *end_g, *end_rr, *del, *fhead, *ftail;
  int* pend;       // (R, S) of this lane
  i64* ring;       // (P, NP, CAP) of this lane
  double *arrival, *first_start, *last_finish, *busy;
  i64* done;
  i64 seq, tok, zpos, fpos;
  int del_n;
  bool overflow;
};

__device__ __forceinline__ void append_deliver(Lane& L, int pid, i64 g, i64 rr, double t) {
  if (L.del_n >= L.K) {  // impossible: a pid waits in the ring at most once
    L.overflow = true;
    return;
  }
  L.idle[pid * L.W] = 0;
  L.del[L.del_n * L.W] = ((i64)(pid + 1) << 42) | ((g + 1) << 21) | (rr + 1);
  if (L.del_n == 0) {
    L.times[(L.C - 1) * L.W] = t;
    L.seqs[(L.C - 1) * L.W] = L.seq;
  }
  ++L.del_n;
  ++L.seq;
}

__device__ __forceinline__ void queue_push(Lane& L, int pid, int cls, i64 g, i64 rr) {
  const i64 q = (i64)pid * L.NP + cls;
  const i64 pos = L.ftail[q * L.W], head = L.fhead[q * L.W];
  if (pos - head >= L.CAP) {
    L.overflow = true;
    return;
  }
  L.ring[q * L.CAP + (pos & (L.CAP - 1))] = ((g + 1) << 21) | (rr + 1);
  L.ftail[q * L.W] = pos + 1;
}

// The reference's release(): the dispatch token first, then the task.
__device__ __forceinline__ void release(Lane& L, i64 g, i64 rr, double t) {
  if (L.any_dispatch && L.dispatch_known) {
    const int dp = (int)L.dispatch_pid;
    if (L.idle[dp * L.W]) append_deliver(L, dp, -1, -1, t);
    else ++L.tok;  // tokens queue only on dispatch_pid: their FIFO is a counter
  }
  const int pid = (int)L.proc_of[g];
  if (L.idle[pid * L.W]) append_deliver(L, pid, g, rr, t);
  else queue_push(L, pid, (int)L.prio_of[g], g, rr);
}

// A worker that finished takes a queued dispatch token, else the head of its
// first non-empty priority FIFO, else goes idle.
__device__ __forceinline__ void pull_next(Lane& L, int pid, double t) {
  if (L.any_dispatch && pid == L.dispatch_pid && L.tok > 0) {
    --L.tok;
    append_deliver(L, pid, -1, -1, t);
    return;
  }
  for (int cls = 0; cls < L.NP; ++cls) {
    const i64 q = (i64)pid * L.NP + cls;
    const i64 head = L.fhead[q * L.W];
    if (head < L.ftail[q * L.W]) {
      const i64 v = L.ring[q * L.CAP + (head & (L.CAP - 1))];
      L.fhead[q * L.W] = head + 1;
      append_deliver(L, pid, ((v >> 21) & M21) - 1, (v & M21) - 1, t);
      return;
    }
  }
  L.idle[pid * L.W] = 1;
}

__device__ __forceinline__ void on_arrival(Lane& L, int gid, double t) {
  const i64 rid = L.src_rid[gid * L.W];
  const double a0 = L.arrtab[(i64)gid * L.NR];
  if (rid == 0 && a0 > t) {  // a first arrival after 0 re-arms the source
    L.times[gid * L.W] = __dadd_rn(t, __dsub_rn(a0, t));
    L.seqs[gid * L.W] = L.seq++;
    return;
  }
  const i64 rr = (i64)gid * L.NR + rid;
  L.arrival[rr] = t;
  int* pend = L.pend + rr * L.S;
  for (int s = 0; s < L.S; ++s) pend[s] = (int)L.dep_cnt[s];
  const int nroots = (int)L.roots_n[gid];
  for (int j = 0; j < nroots; ++j) release(L, L.roots[(i64)gid * L.J + j], rr, t);
  const i64 nrid = rid + 1;
  if (nrid < L.nr) {
    const double next = L.arrtab[(i64)gid * L.NR + nrid];
    L.times[gid * L.W] = __dadd_rn(t, __dsub_rn(next, t));
    L.seqs[gid * L.W] = L.seq++;
    L.src_rid[gid * L.W] = nrid;
  } else {
    L.times[gid * L.W] = __longlong_as_double(0x7ff0000000000000LL);
    L.seqs[gid * L.W] = BIGSEQ;
  }
}

__device__ __forceinline__ void on_completion(Lane& L, int pid, double t) {
  const i64 g = L.end_g[pid * L.W], rr = L.end_rr[pid * L.W];
  if (g >= 0) {  // a dispatch token's completion carries no task
    L.done[rr] += 1;
    if (t > L.last_finish[rr]) L.last_finish[rr] = t;
    int* pend = L.pend + rr * L.S;
    const int nsucc = (int)L.succ_cnt[g];
    for (int j = 0; j < nsucc; ++j) {
      const i64 sj = L.succ_pad[g * L.DM + j];
      if (--pend[sj] == 0) release(L, sj, rr, t);
    }
  }
  L.times[(L.G + pid) * L.W] = __longlong_as_double(0x7ff0000000000000LL);
  L.seqs[(L.G + pid) * L.W] = BIGSEQ;
  L.end_g[pid * L.W] = -2;
  pull_next(L, pid, t);
}

// Every pending delivery shares the drain's timestamp and precedes all other
// events, so the ring drains in slot (= seq) order.
__device__ __forceinline__ void on_drain(Lane& L, double t) {
  for (int k = 0; k < L.del_n; ++k) {
    const i64 v = L.del[k * L.W];
    const int pid = (int)((v >> 42) - 1);
    const i64 g = ((v >> 21) & M21) - 1, rr = (v & M21) - 1;
    const i64 col = (i64)(L.G + pid) * L.W;
    if (g < 0) {  // dispatch token: the Coordinator's load on dispatch_pid
      L.busy[pid] = __dadd_rn(L.busy[pid], L.dispatch_ov);
      L.times[col] = __dadd_rn(t, L.dispatch_ov);
      L.seqs[col] = L.seq++;
      L.end_g[pid * L.W] = -1;
      continue;
    }
    double exec_t = L.exec_v[g], total = L.total_v[g];
    const double cm = L.overlap ? 0.0 : L.comm_v[g];
    if (L.any_noise && L.noisy && L.sigma_pos[pid]) {
      const i64 z = L.zpos < L.ZC - 1 ? L.zpos : L.ZC - 1;
      ++L.zpos;
      const double et = __dmul_rn(exec_t, L.emult[z * L.P + pid]);
      // the scalar loop's order: exec + quant + (0 | comm)
      total = __dadd_rn(__dadd_rn(et, L.quant_v[g]), cm);
      exec_t = et;
    }
    if (L.any_fault && L.faulted) {
      double ex_f = exec_t;
      if (L.any_strag && L.strag_on) {  // one straggler draw per delivery
        const i64 f = L.fpos < L.FC - 1 ? L.fpos : L.FC - 1;
        ++L.fpos;
        ex_f = __dmul_rn(ex_f, L.strag_tab[f]);
      }
      for (int ti = 0; ti < L.T; ++ti)
        if (L.thr_pid[ti] == pid && L.thr_t0[ti] <= t && t < L.thr_t1[ti])
          ex_f = __dmul_rn(ex_f, L.thr_fac[ti]);
      double stall = 0.0;
      for (int di = 0; di < L.D; ++di)
        if (L.drop_pid[di] == pid && L.drop_t0[di] <= t && t < L.drop_t1[di]) {
          stall = __dsub_rn(L.drop_t1[di], t);
          break;
        }
      double tt = __dadd_rn(__dadd_rn(ex_f, L.quant_v[g]), cm);
      if (stall > 0.0) tt = __dadd_rn(stall, tt);
      exec_t = ex_f;
      total = tt;
    }
    if (t < L.first_start[rr]) L.first_start[rr] = t;
    // a permanent dropout's stall is infinite: its completion never fires
    if (isfinite(total)) L.busy[pid] = __dadd_rn(L.busy[pid], total);
    L.times[col] = __dadd_rn(t, total);
    L.seqs[col] = L.seq++;
    L.end_g[pid * L.W] = g;
    L.end_rr[pid * L.W] = rr;
  }
  L.del_n = 0;
  L.times[(L.C - 1) * L.W] = __longlong_as_double(0x7ff0000000000000LL);
  L.seqs[(L.C - 1) * L.W] = BIGSEQ;
}

__global__ void __launch_bounds__(32)
    batchsim_advance_thread_kernel(const i64* __restrict__ tab, i64* __restrict__ out,
                                   i64* __restrict__ scratch) {
  const i64 W = tab[H_W];
  const i64 lane = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= W) return;
  Lane L;
  L.W = W;
  L.G = (int)tab[H_G]; L.P = (int)tab[H_P]; L.NP = (int)tab[H_NP]; L.CAP = (int)tab[H_CAP];
  L.S = (int)tab[H_S]; L.NR = (int)tab[H_NR]; L.J = (int)tab[H_J]; L.DM = (int)tab[H_DM];
  L.ZC = (int)tab[H_ZC]; L.FC = (int)tab[H_FC]; L.T = (int)tab[H_T]; L.D = (int)tab[H_D];
  L.any_noise = tab[H_ANY_NOISE] != 0; L.any_fault = tab[H_ANY_FAULT] != 0;
  L.any_strag = tab[H_ANY_STRAG] != 0; L.any_dispatch = tab[H_ANY_DISPATCH] != 0;
  const i64 itercap = tab[H_ITERCAP];
  L.C = L.G + L.P + 1;
  L.K = L.P + 1;
  const i64 R = (i64)L.G * L.NR;
  const i64* off = tab + H_COUNT;
  auto I = [&](int t, i64 row) { return tab + off[t] + lane * row; };
  auto F = [&](int t, i64 row) { return reinterpret_cast<const double*>(tab + off[t]) + lane * row; };
  L.arrtab = F(T_ARRTAB, R);
  L.horizon = *F(T_HORIZON, 1);
  L.nr = *I(T_NR, 1);
  L.proc_of = I(T_PROC_OF, L.S); L.prio_of = I(T_PRIO_OF, L.S);
  L.exec_v = F(T_EXEC_V, L.S); L.quant_v = F(T_QUANT_V, L.S);
  L.comm_v = F(T_COMM_V, L.S); L.total_v = F(T_TOTAL_V, L.S);
  L.dep_cnt = I(T_DEP_CNT, L.S); L.succ_pad = I(T_SUCC_PAD, (i64)L.S * L.DM);
  L.succ_cnt = I(T_SUCC_CNT, L.S); L.roots = I(T_ROOTS, (i64)L.G * L.J);
  L.roots_n = I(T_ROOTS_N, L.G);
  L.overlap = *I(T_OVERLAP, 1) != 0;
  L.dispatch_ov = *F(T_DISPATCH_OV, 1);
  L.dispatch_pid = *I(T_DISPATCH_PID, 1);
  L.dispatch_known = *I(T_DISPATCH_KNOWN, 1) != 0;
  L.noisy = *I(T_NOISY, 1) != 0;
  L.sigma_pos = I(T_SIGMA_POS, L.P);
  L.emult = F(T_EMULT, (i64)L.ZC * L.P);
  L.faulted = *I(T_FAULTED, 1) != 0;
  L.strag_on = *I(T_STRAG_ON, 1) != 0;
  L.strag_tab = F(T_STRAG_TAB, L.FC);
  L.thr_pid = I(T_THR_PID, L.T); L.thr_t0 = F(T_THR_T0, L.T);
  L.thr_t1 = F(T_THR_T1, L.T); L.thr_fac = F(T_THR_FAC, L.T);
  L.drop_pid = I(T_DROP_PID, L.D); L.drop_t0 = F(T_DROP_T0, L.D);
  L.drop_t1 = F(T_DROP_T1, L.D);
  const i64* idle0 = tab + off[T_IDLE0];

  // outputs: arrival, first_start, last_finish, done (W, R); busy (W, P);
  // overflow, iters, pushes (W)
  const i64 WR = W * R;
  double* fout = reinterpret_cast<double*>(out);
  L.arrival = fout + lane * R;
  L.first_start = fout + WR + lane * R;
  L.last_finish = fout + 2 * WR + lane * R;
  L.done = out + 3 * WR + lane * R;
  L.busy = fout + 4 * WR + lane * L.P;
  i64* overflow_out = out + 4 * WR + W * L.P;
  i64* iters_out = overflow_out + W;
  i64* pushes_out = iters_out + W;

  // scratch: lane-minor state, then the pending counters, then the rings
  const i64 nst = state_words(L.G, L.P, L.NP);
  i64* st = scratch + lane;
  L.times = reinterpret_cast<double*>(st);
  L.seqs = st + (i64)L.C * W;
  L.src_rid = st + 2 * (i64)L.C * W;
  L.idle = L.src_rid + (i64)L.G * W;
  L.end_g = L.idle + (i64)L.P * W;
  L.end_rr = L.end_g + (i64)L.P * W;
  L.del = L.end_rr + (i64)L.P * W;
  L.fhead = L.del + (i64)L.K * W;
  L.ftail = L.fhead + (i64)L.P * L.NP * W;
  const i64 pend_words = (W * R * L.S + 1) / 2;
  L.pend = reinterpret_cast<int*>(scratch + nst * W) + lane * R * L.S;
  L.ring = scratch + nst * W + pend_words + lane * (i64)L.P * L.NP * L.CAP;

  const double INF = __longlong_as_double(0x7ff0000000000000LL);
  for (int c = 0; c < L.C; ++c) {
    L.times[c * W] = c < L.G ? 0.0 : INF;
    L.seqs[c * W] = c < L.G ? (i64)c : BIGSEQ;
  }
  for (int g = 0; g < L.G; ++g) L.src_rid[g * W] = 0;
  for (int p = 0; p < L.P; ++p) {
    L.idle[p * W] = idle0[p];
    L.end_g[p * W] = -2;
    L.end_rr[p * W] = -1;
    L.busy[p] = 0.0;
  }
  for (int q = 0; q < L.P * L.NP; ++q) {
    L.fhead[q * W] = 0;
    L.ftail[q * W] = 0;
  }
  for (i64 r = 0; r < R; ++r) {
    L.arrival[r] = 0.0;
    L.first_start[r] = INF;
    L.last_finish[r] = 0.0;
    L.done[r] = 0;
  }
  L.seq = L.G;
  L.tok = L.zpos = L.fpos = 0;
  L.del_n = 0;
  L.overflow = false;

  i64 it = 0;
  while (it < itercap) {
    // the frontier's earliest (time, seq)
    double tmin = L.times[0];
    i64 smin = L.seqs[0];
    int ci = 0;
    for (int c = 1; c < L.C; ++c) {
      const double tc = L.times[c * W];
      const i64 sc = L.seqs[c * W];
      if (tc < tmin || (tc == tmin && sc < smin)) {
        tmin = tc;
        smin = sc;
        ci = c;
      }
    }
    if (!(tmin <= L.horizon)) break;
    if (ci < L.G) on_arrival(L, ci, tmin);
    else if (ci < L.G + L.P) on_completion(L, ci - L.G, tmin);
    else on_drain(L, tmin);
    ++it;
    if (L.overflow) break;
  }
  overflow_out[lane] = L.overflow ? 1 : 0;
  iters_out[lane] = it;
  i64 pushes = 0;
  for (int q = 0; q < L.P * L.NP; ++q) pushes += L.ftail[q * L.W];
  pushes_out[lane] = pushes;
}

}  // namespace per_thread

extern "C" {

// Scratch in 64-bit words for a batch of these sizes (NR is the padded
// requests per group): the pending counters, then the FIFO rings.
long long batchsim_advance_scratch_words(int W, int G, int P, int NP, int CAP, int S, int NR) {
  return pend_words(W, (i64)G * NR, S) + (i64)W * P * NP * CAP;
}

// The most dynamic shared memory a block may have on the device.
int batchsim_advance_shared_limit(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// shared_bytes: LANES_PER_BLOCK x shared_words(G, P, NP) x 8 for the batch's
// sizes (batchsim_advance.py: shared_bytes), held by the caller to the
// device's limit.
int batchsim_advance(const long long* tab, long long* out, long long* scratch, int lanes,
                     long long shared_bytes, void* stream) {
  if (lanes <= 0 || shared_bytes <= 0 || shared_bytes > INT_MAX) return (int)cudaErrorInvalidValue;
  if (shared_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(warp_lane::batchsim_advance_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (lanes + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK;
  warp_lane::batchsim_advance_kernel<<<blocks, 32 * LANES_PER_BLOCK, (size_t)shared_bytes,
                      (cudaStream_t)stream>>>(tab, out, scratch);
  return (int)cudaGetLastError();
}

// The thread-per-lane kernel's scratch: its lane-minor state, then the same
// pending counters and rings.
long long batchsim_advance_thread_scratch_words(int W, int G, int P, int NP, int CAP, int S,
                                                int NR) {
  return per_thread::state_words(G, P, NP) * W +
         batchsim_advance_scratch_words(W, G, P, NP, CAP, S, NR);
}

int batchsim_advance_thread(const long long* tab, long long* out, long long* scratch, int lanes,
                            void* stream) {
  if (lanes <= 0) return (int)cudaErrorInvalidValue;
  const int block = 32;
  per_thread::batchsim_advance_thread_kernel<<<(lanes + block - 1) / block, block, 0,
                                                (cudaStream_t)stream>>>(tab, out, scratch);
  return (int)cudaGetLastError();
}

const char* batchsim_advance_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
