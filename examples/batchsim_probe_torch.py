"""Time design alternatives of the compiled batch tier's kernel on the card.

Builds variants of ``src/repro_torch/kernels/csrc/batchsim_advance.cu`` (each
made by rewriting the committed source) and times them in turns, with the
committed kernel and the thread-per-lane kernel it replaced, on the batch
``chip_smoke.py``'s ``kernel_check`` takes (sweep scenario 1's widest
α*-search batch) and on that batch tiled to 1024 lanes. Every variant must
give the committed kernel's outputs bit for bit. An instrumented variant
splits the longest lane's cycles between the frontier's argmin and the
three handlers (``clock64`` around each; its own cost is in the numbers).

Variants: ``shuffle_min`` (the argmin as a butterfly of shuffles on (time,
seq, column)), ``serial_min`` (thread 0 scans the frontier, one broadcast),
``serial_pull`` (thread 0 scans the FIFO classes), ``tables_shared`` (the
small read-only tables staged in shared memory), ``outputs_shared`` (the
per-request outputs kept in shared memory, written out at the end),
``one_warp_a_block``, ``instrumented``.

Usage, on a machine with the card and ``nvcc``:
    PYTHONPATH=src python examples/batchsim_probe_torch.py
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import repro_torch.core.batchsim_compiled as bsc
from repro_torch.experiments import SweepConfig, evaluate_scenario, generate_scenario_specs
from repro_torch.experiments.evaluate import default_context
from repro_torch.kernels import batchsim_advance as kb
from repro_torch.kernels.build import CSRC, NVCC_FLAGS, _nvcc

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "batchsim_probe"
SRC = (CSRC / "batchsim_advance.cu").read_text()
RO_TABLES = ("exec_v", "quant_v", "comm_v", "total_v", "proc_of", "prio_of", "dep_cnt",
             "succ_cnt", "succ_pad", "roots", "roots_n")


def rep(s, old, new):
    if old not in s:
        raise ValueError(f"anchor not in the source: {old[:60]!r}")
    return s.replace(old, new, 1)


def replace_function(s, head, body):
    i = s.index(head)
    return s[:i] + body + s[s.index("\n}\n", i) + 3:]


SHUFFLE_MIN = r"""__device__ __forceinline__ void frontier_min(const Lane& L, double& tmin, int& ci) {
  double t = inf();
  i64 s = LLONG_MAX;
  int c = INT_MAX;
  for (int k = L.lane; k < L.C; k += 32) {
    const double tk = L.times[k];
    const i64 sk = L.seqs[k];
    if (tk < t || (tk == t && sk < s)) { t = tk; s = sk; c = k; }
  }
  int span = 1;
  while (span < L.C && span < 32) span <<= 1;
  for (int off = span >> 1; off > 0; off >>= 1) {
    const double to = __shfl_xor_sync(FULL, t, off);
    const i64 so = __shfl_xor_sync(FULL, s, off);
    const int co = __shfl_xor_sync(FULL, c, off);
    if (to < t || (to == t && (so < s || (so == s && co < c)))) { t = to; s = so; c = co; }
  }
  tmin = __shfl_sync(FULL, t, 0);
  ci = __shfl_sync(FULL, c, 0);
}
"""

SERIAL_MIN = r"""__device__ __forceinline__ void frontier_min(const Lane& L, double& tmin, int& ci) {
  double t = 0.0;
  int c = 0;
  if (L.lead) {
    t = L.times[0];
    i64 s = L.seqs[0];
    for (int k = 1; k < L.C; ++k) {
      const double tk = L.times[k];
      const i64 sk = L.seqs[k];
      if (tk < t || (tk == t && sk < s)) { t = tk; s = sk; c = k; }
    }
  }
  tmin = __shfl_sync(FULL, t, 0);
  ci = __shfl_sync(FULL, c, 0);
}
"""

SERIAL_PULL = r"""__device__ __forceinline__ void pull_next(Lane& L, int pid, double t) {
  if (!L.lead) return;
  if (L.any_dispatch && pid == L.dispatch_pid && L.tok > 0) {
    --L.tok;
    append_deliver(L, pid, -1, -1, t);
    return;
  }
  for (int cls = 0; cls < L.NP; ++cls) {
    const int q = pid * L.NP + cls;
    const i64 head = L.fhead[q];
    if (head < L.ftail[q]) {
      const i64 v = L.ring[(i64)q * L.CAP + (head & (L.CAP - 1))];
      L.fhead[q] = head + 1;
      append_deliver(L, pid, ((v >> 21) & M21) - 1, (v & M21) - 1, t);
      return;
    }
  }
  L.idle[pid] = 1;
}
"""


def tables_shared(s):
    for t in RO_TABLES:
        s = s.replace(f"__ldg(L.{t}", f"ro(L.{t}")
    s = rep(s, "namespace warp_lane {\n", "namespace warp_lane {\ntemplate <class T> "
            "__device__ __forceinline__ T ro(const T* p) { return *p; }\n")
    return rep(s, "  const double INF = inf();\n  for (int c = L.lane;", """  {
    const i64 S = L.S;
    i64* p = smem + LANES_PER_BLOCK * shared_words(L.G, L.P, L.NP)
             + warp * (8 * S + S * L.DM + (i64)L.G * L.J + L.G);
    auto stage = [&](const void* src, i64 n) {
      i64* dst = p;
      for (i64 i = L.lane; i < n; i += 32) dst[i] = __ldg((const i64*)src + i);
      p += n;
      return dst;
    };
    L.exec_v = (const double*)stage(L.exec_v, S); L.quant_v = (const double*)stage(L.quant_v, S);
    L.comm_v = (const double*)stage(L.comm_v, S); L.total_v = (const double*)stage(L.total_v, S);
    L.proc_of = stage(L.proc_of, S); L.prio_of = stage(L.prio_of, S);
    L.dep_cnt = stage(L.dep_cnt, S); L.succ_cnt = stage(L.succ_cnt, S);
    L.succ_pad = stage(L.succ_pad, S * L.DM); L.roots = stage(L.roots, (i64)L.G * L.J);
    L.roots_n = stage(L.roots_n, L.G);
  }
  const double INF = inf();
  for (int c = L.lane;""")


def outputs_shared(s):
    s = rep(s, """  L.arrival = fout + lane * R;
  L.first_start = fout + WR + lane * R;
  L.last_finish = fout + 2 * WR + lane * R;
  L.done = out + 3 * WR + lane * R;""", """  double* g_arrival = fout + lane * R;
  double* g_first = fout + WR + lane * R;
  double* g_last = fout + 2 * WR + lane * R;
  i64* g_done = out + 3 * WR + lane * R;
  i64* osh = smem + LANES_PER_BLOCK * shared_words(L.G, L.P, L.NP) + warp * 4 * R;
  L.arrival = (double*)osh; L.first_start = (double*)(osh + R);
  L.last_finish = (double*)(osh + 2 * R); L.done = osh + 3 * R;""")
    return rep(s, "  if (L.lead) {\n    overflow_out[lane] = L.overflow ? 1 : 0;", """  for (i64 r = L.lane; r < R; r += 32) {
    g_arrival[r] = L.arrival[r]; g_first[r] = L.first_start[r];
    g_last[r] = L.last_finish[r]; g_done[r] = L.done[r];
  }
  if (L.lead) {
    overflow_out[lane] = L.overflow ? 1 : 0;""")


def instrumented(s):
    s = rep(s, "namespace warp_lane {\n",
            "__device__ long long probe_cycles[8192 * 8];\nnamespace warp_lane {\n")
    s = rep(s, "  i64 it = 0;\n  while (it < itercap) {\n", """  i64 it = 0;
  long long cyc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  while (it < itercap) {
    const long long c0 = clock64();
""")
    s = rep(s, "    frontier_min(L, tmin, ci);\n    if (!(tmin <= L.horizon)) break;\n", """    frontier_min(L, tmin, ci);
    const long long c1 = clock64();
    if (!(tmin <= L.horizon)) break;
    const int kind = ci < L.G ? 0 : (ci < L.G + L.P ? 1 : 2);
""")
    s = rep(s, "    if (__shfl_sync(FULL, (int)L.overflow, 0)) break;\n  }\n", """    if (__shfl_sync(FULL, (int)L.overflow, 0)) break;
    const long long c2 = clock64();
    cyc[0] += c1 - c0;
    cyc[1 + kind] += c2 - c1;
    cyc[4 + kind] += 1;
  }
""")
    s = rep(s, "  if (L.lead) {\n    overflow_out[lane] = L.overflow ? 1 : 0;", """  cyc[7] = it;
  if (L.lead && lane < 8192)
    for (int k = 0; k < 8; ++k) probe_cycles[lane * 8 + k] = cyc[k];
  if (L.lead) {
    overflow_out[lane] = L.overflow ? 1 : 0;""")
    return rep(s, 'extern "C" {\n', 'extern "C" {\nint probe_read(long long* host, int n) {\n'
               '  return (int)cudaMemcpyFromSymbol(host, probe_cycles, (size_t)n * 8);\n}\n')


# name: (source, lanes a block, extra shared words of a lane as f(sizes))
def _tables_words(z):
    return 8 * z["S"] + z["S"] * z["DM"] + z["G"] * z["J"] + z["G"]


VARIANTS = {
    "committed": (SRC, 2, None),
    "shuffle_min": (replace_function(SRC, "__device__ __forceinline__ void frontier_min(",
                                     SHUFFLE_MIN), 2, None),
    "serial_min": (replace_function(SRC, "__device__ __forceinline__ void frontier_min(",
                                    SERIAL_MIN), 2, None),
    "serial_pull": (replace_function(SRC, "__device__ __forceinline__ void pull_next(",
                                     SERIAL_PULL), 2, None),
    "tables_shared": (tables_shared(SRC), 2, _tables_words),
    "outputs_shared": (outputs_shared(SRC), 2, lambda z: 4 * z["G"] * z["NR"]),
    "one_warp_a_block": (rep(SRC, "constexpr int LANES_PER_BLOCK = 2;",
                             "constexpr int LANES_PER_BLOCK = 1;"), 1, None),
    "instrumented": (instrumented(SRC), 2, None),
}


def build():
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (src, _, _) in VARIANTS.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
                                        str(cu)], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        at = next(i for i, line in enumerate(lines) if "entry function '_ZN9warp_lane" in line)
        ptxas[name] = [line.strip() for line in lines[at:at + 4]
                       if "Used" in line or "spill" in line]
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.batchsim_advance.argtypes = ([ctypes.c_void_p] * 3
                                         + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
        lib.batchsim_advance_scratch_words.argtypes = [ctypes.c_int] * 7
        lib.batchsim_advance_scratch_words.restype = ctypes.c_longlong
        libs[name] = lib
    return libs, ptxas


def launcher(lib, name, prep):
    z = prep.sizes
    _, lanes_a_block, extra = VARIANTS[name]
    words = kb.shared_words(z["G"], z["P"], z["NP"]) + (extra(z) if extra else 0)
    nbytes = 8 * lanes_a_block * words
    buf = prep.packed.to("cuda")
    W, P, R = z["W"], z["P"], z["G"] * z["NR"]
    out = torch.empty(4 * W * R + W * P + 3 * W, dtype=torch.int64, device="cuda")
    scratch = torch.empty(lib.batchsim_advance_scratch_words(*kb._scratch_args(z)),
                          dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def go():
        err = lib.batchsim_advance(buf.data_ptr(), out.data_ptr(), scratch.data_ptr(), W,
                                   nbytes, stream)
        if err:
            raise RuntimeError(f"{name}: launch error {err}")
    return go, out


def cuda_ms(fn, iters=5):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("batchsim_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    mhz = float(smi.split(",")[-1])
    libs, ptxas = build()
    print(json.dumps({"ptxas": ptxas, "smi": smi}), flush=True)
    preps = []
    real = bsc.prepare_batch
    bsc.prepare_batch = lambda *a, **kw: preps.append(real(*a, **kw)) or preps[-1]
    evaluate_scenario(generate_scenario_specs(2, seed=0)[1],
                      SweepConfig(use_batch=True, batch_engine="compiled"), default_context())
    bsc.prepare_batch = real
    prep = max(preps, key=lambda p: len(p.lanes))
    tiled = bsc.prepare_batch([prep.lanes[i % len(prep.lanes)] for i in range(1024)],
                              prep.groups, default_context().processors)
    for label, p in (("scenario 1's widest batch", prep), ("tiled to 1024 lanes", tiled)):
        runs = {name: launcher(lib, name, p) for name, lib in libs.items()}
        buf = p.packed.to("cuda")
        runs["thread_per_lane"] = (lambda: kb._batchsim_advance_thread(buf, p.sizes), None)
        for go, _ in runs.values():
            go()
        torch.cuda.synchronize()
        base = runs["committed"][1]
        equal = {n: bool(torch.equal(o, base)) for n, (_, o) in runs.items() if o is not None}
        times = {n: [] for n in runs}
        for _ in range(3):
            for n in list(runs) + list(runs)[::-1]:
                times[n].append(cuda_ms(runs[n][0]))
        W = p.sizes["W"]
        longest = int(base[-2 * W:-W].max())
        host = (ctypes.c_longlong * (8 * min(W, 8192)))()
        if libs["instrumented"].probe_read(host, len(host)):
            raise RuntimeError("probe_read failed")
        rows = [host[8 * i:8 * i + 8] for i in range(len(host) // 8)]
        lane = max(rows, key=lambda r: r[7])
        split = {"argmin": lane[0] / max(lane[7], 1)}
        for k, what in enumerate(("arrival", "completion", "drain")):
            split[what] = {"events": lane[4 + k], "cycles_each": lane[1 + k] / max(lane[4 + k], 1)}
        print(json.dumps({
            "batch": label, "lanes": len(p.lanes), "padded_lanes": W,
            "longest_lane_events": longest, "equal_to_committed": equal,
            "ms": {n: min(t) for n, t in times.items()},
            "ms_max": {n: max(t) for n, t in times.items()},
            "cycles_per_event": {n: min(t) * 1e-3 * mhz * 1e6 / longest
                                 for n, t in times.items()},
            "instrumented_cycles_per_event_longest_lane": split, "smi": smi}), flush=True)
        if not all(equal.values()):
            raise AssertionError(f"a variant differs from the committed kernel: {equal}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
