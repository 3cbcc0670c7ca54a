// The compiled batch tier's event loop for Hopper (sm_90a): one thread per lane.
//
// Replaces the XLA-compiled jax.lax.while_loop of
// src/repro/core/batchsim_compiled.py (_advance_factory, :117). A batch holds
// W independent scheduler simulations (lanes) of one scenario; each lane is a
// discrete-event loop over request arrivals, worker completions and the drain
// of its pending deliveries, ordered by the (time, seq) key of the numpy
// BatchSimulator. The reference advances all lanes in lock-step, one event per
// lane per iteration, as masked full-width updates. Lanes never interact, so
// here each thread runs one lane's whole loop to quiescence and the batch is
// one launch; nothing is synchronised.
//
// What bounds it: latency. A lane is one dependent chain of events: each picks
// its successor from the lane's frontier, and each step is a handful of
// dependent loads and stores that hit L1 or L2. The work is no more than the
// events of the longest lane times the frontier width (G + P + 1 columns
// scanned per event), and the bytes are small: the packed tables read (W x
// (subgraphs x ~10 + requests x groups + noise and straggler tables) words),
// the outputs written (W x (4 R + P + 3) words), the ring traffic (one word
// written and one read per queued task) and the pending counters (S int32
// written per arrived request). At a few hundred lanes the card could move
// those bytes in microseconds; a launch takes as long as its longest lane's
// chain of events, at least (events x (G + P + 1)) dependent compares.
//
// What the design does about it: no lock-step, so a lane never waits for
// another's events and no masked work is done for idle lanes; one warp per
// block, so the lanes spread over as many SMs as there are warps; the per-lane
// state (frontier, worker slots, delivery ring, FIFO heads and tails) is laid
// out lane-minor like local memory, so the warp's lanes read the same column
// of the frontier scan in one coalesced request; the (lane, pid, class) FIFO
// rings sit in one global buffer, each lane's rings contiguous. A warp per lane,
// shared-memory rings or a persistent grid are later work.
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

__global__ void __launch_bounds__(32) batchsim_advance_kernel(const i64* __restrict__ tab,
                                                              i64* __restrict__ out,
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

extern "C" {

// Scratch in 64-bit words for a batch of these sizes (NR is the padded
// requests per group).
long long batchsim_advance_scratch_words(int W, int G, int P, int NP, int CAP, int S, int NR) {
  const i64 R = (i64)G * NR;
  return state_words(G, P, NP) * W + ((i64)W * R * S + 1) / 2 + (i64)W * P * NP * CAP;
}

int batchsim_advance(const long long* tab, long long* out, long long* scratch, int lanes,
                     void* stream) {
  if (lanes <= 0) return (int)cudaErrorInvalidValue;
  const int block = 32;
  batchsim_advance_kernel<<<(lanes + block - 1) / block, block, 0, (cudaStream_t)stream>>>(
      tab, out, scratch);
  return (int)cudaGetLastError();
}

const char* batchsim_advance_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
