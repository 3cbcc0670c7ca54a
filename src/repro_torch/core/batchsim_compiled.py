"""Compiled lock-step batch core: the numpy pass as one kernel launch on the card.

:mod:`repro_torch.core.batchsim` advances every lane's event frontier with
masked numpy array ops: correct and bit-exact, but interpreter-bound. The
reference (``repro.core.batchsim_compiled``) ports that pass into one
``jax.lax.while_loop`` compiled by XLA. Here it becomes a kernel written by
hand for the H100, ``kernels/csrc/batchsim_advance.cu``, in which one warp
runs one lane's whole event loop, and on the CPU the plain pass
:func:`~repro_torch.kernels.batchsim_advance.advance_plain`, the reference's
lock-step loop in torch float64 (see :mod:`repro_torch.kernels.batchsim_advance`).

Tolerance contract
------------------
The compiled tier is **not** contractually bit-exact; it is exact on
*inputs* and bounded on *arithmetic*:

* every RNG-derived quantity is precomputed host-side with the scalar
  engines' exact expressions — arrival tables via ``draw_arrivals``, noise
  z-draws via ``random.Random(seed).gauss`` with the multiplier computed by
  ``math.exp`` (per ``(draw index, pid)``, gathered in-loop), straggler
  multipliers via the one-draw-per-delivery ``random.Random`` stream with
  the scalar Pareto expression — so the loop consumes bit-identical event
  inputs;
* the in-loop float arithmetic uses the same operation order as the scalar
  engines, with no fused multiply-add on either side, so results carry a
  documented bounded tolerance instead of a bit-parity promise:
  :data:`COMPILED_REL_TOL` relative / :data:`COMPILED_ABS_TOL` absolute per
  reported float. The numpy tier remains the bit-exact parity oracle (the
  reference's own compiled tier cannot be one: it fails to import on the
  jax it is tested with).

Fallbacks (handled by :func:`repro_torch.core.batchsim.run_batch`)
------------------------------------------------------------------
Two kinds of batch are declined before anything is launched:

* ``collect_tasks=True`` — task-trace collection is python-side by design;
* ready-queue bound — each ``(lane, pid, priority class)`` FIFO ring has a
  fixed capacity (host-computed from the lane's task-count bound); a batch
  whose bound exceeds :data:`QUEUE_CAP_MAX` is declined.

Each reruns the batch on the numpy tier, whose queues grow without bound,
and is counted in :data:`fallbacks` by its reason; :data:`last_stats`
describes the latest call. Once the loop has run, nothing falls back: a
ring overflow or a lane at the iteration cap is impossible by construction,
so either means the loop is wrong, and the call raises, naming the lanes.
Without ``device="cpu"`` the call needs a card, and a build or launch
failure raises.

Ready queues: FIFO rings instead of scanned slots
-------------------------------------------------
``release_seq`` is a per-lane monotone counter, so pushes into any single
``(class, priority)`` bucket already arrive in key order. Pop order
``(class, priority, seq)`` therefore reduces to "first non-empty FIFO in
class order" — one dispatch-token FIFO (class 0, a counter, since tokens
carry no payload) plus one FIFO per priority rank — giving O(1) pushes and
pops with no key storage and no scans, at any capacity.

Port of ``repro.core.batchsim_compiled``: the host preparation is the
reference's (lines 510-724); the advance is new.
"""
from __future__ import annotations

import math
import random
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from .arrivals import arrival_horizon, draw_arrivals
from .processors import Processor

#: Documented tolerance of the compiled tier relative to the bit-exact
#: numpy tier, per reported float (makespans, busy times, timestamps).
COMPILED_REL_TOL = 1e-9
COMPILED_ABS_TOL = 1e-12

#: Hard cap on the per-(lane, pid, priority class) FIFO-ring capacity. The
#: actual capacity is the power-of-two bucket of the lane set's exact
#: released-task bound (``num_requests × tasks per request``), so overflow
#: is impossible below the cap; workloads whose bound exceeds it run on the
#: numpy tier (its queues grow without bound).
QUEUE_CAP_MAX = 4096

#: Why a batch asked for ``engine="compiled"`` ran on the numpy tier.
FALLBACK_REASONS = ("collect-tasks", "queue-bound")

#: Diagnostics of the most recent :func:`run_batch_compiled` call:
#: ``{"iters", "itercap", "fallback"}`` (and ``"reason"`` on a fallback).
#: Tests and ``chip_smoke.py`` read this to tell a compiled run from a
#: fallback.
last_stats: dict = {}

#: Fallbacks since import, by reason (counted under a lock).
fallbacks = dict.fromkeys(FALLBACK_REASONS, 0)
_STATS_LOCK = threading.Lock()


def note_fallback(reason: str, **stats) -> None:
    """Record one fallback to the numpy tier in :data:`last_stats` and
    :data:`fallbacks`."""
    with _STATS_LOCK:
        fallbacks[reason] += 1
        last_stats.clear()
        last_stats.update(dict(iters=0, itercap=0), **stats, fallback=True,
                          reason=reason)


def _bucket(n: int, lo: int = 1) -> int:
    """Round ``n`` up to a power of two (≥ ``lo``)."""
    v = max(int(n), lo)
    return 1 << (v - 1).bit_length()


@dataclass
class PreparedBatch:
    """A batch's host tables, packed for one transfer, and what the result
    needs besides the loop's outputs."""

    packed: torch.Tensor            # int64 words on the CPU (pack_tables)
    sizes: Dict[str, int]           # the packed header: padded sizes, flags
    lanes: list
    groups: list
    pids: list
    num_requests: np.ndarray        # (W,) of the real lanes
    horizon: np.ndarray
    group_tasks: np.ndarray


def run_batch_compiled(
    lanes: Sequence,
    groups: Sequence[Sequence[int]],
    processors: Sequence[Processor],
    *,
    collect_tasks: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Optional[object]:
    """Run a batch through the compiled core; ``None`` requests fallback.

    Inputs (arrival tables, noise multipliers, straggler multipliers) are
    precomputed host-side with the scalar engines' exact expressions
    (:func:`prepare_batch`); the loop then advances every lane to
    quiescence on ``device`` (``None`` = the card; the plain pass runs only
    for ``device="cpu"``). The device is resolved here, once, before
    anything else, so a call without a card and without ``device="cpu"``
    raises whatever the batch. Returns a
    :class:`repro_torch.core.batchsim.BatchResult` (``tasks=None``), or
    ``None`` (counted) when the batch asks for ``collect_tasks`` or a
    ring's bound exceeds :data:`QUEUE_CAP_MAX` — the caller reruns on the
    bit-exact numpy tier in those cases.
    """
    dev = resolve_device(device)
    if collect_tasks:
        note_fallback("collect-tasks")
        return None
    prep = prepare_batch(lanes, groups, processors)
    return None if prep is None else run_prepared(prep, dev)


def prepare_batch(
    lanes: Sequence,
    groups: Sequence[Sequence[int]],
    processors: Sequence[Processor],
) -> Optional[PreparedBatch]:
    """The host side of :func:`run_batch_compiled`: every table of the
    batch, padded and packed. ``None`` (counted) when a FIFO ring's bound
    exceeds :data:`QUEUE_CAP_MAX`."""
    from ..kernels.batchsim_advance import PACK_LIMIT, pack_tables
    from .batchsim import BatchSimulator

    sim = BatchSimulator(lanes, groups, processors)
    lanes = sim.lanes
    groups = sim.groups
    pids = sim.pids
    (W, S, P, G, proc_of, prio_of, exec_v, quant_v, comm_v, total_v,
     dep_cnt, net_of, k_of, succ_pad, succ_cnt, dmax, roots, roots_n,
     jmax, group_tasks) = sim._pad_specs()

    nr = np.array([ln.num_requests for ln in lanes], np.int64)
    nr_max = int(nr.max())
    horizon = np.zeros(W)
    arrtab_raw = np.zeros((W, G, max(nr_max, 1)))
    for b, ln in enumerate(lanes):
        tables = draw_arrivals(ln.arrivals, ln.periods, ln.num_requests)
        for gi, tab in enumerate(tables):
            arrtab_raw[b, gi, :len(tab)] = tab
        horizon[b] = arrival_horizon(tables, ln.periods, ln.num_requests)

    dispatch_ov = np.array([ln.dispatch_overhead for ln in lanes])
    dispatch_pid = np.array([ln.dispatch_pid for ln in lanes], np.int64)
    dispatch_known = (dispatch_ov > 0) & np.isin(dispatch_pid, np.array(pids))
    dispatch_pid = np.clip(dispatch_pid, 0, P - 1)
    any_dispatch = bool(dispatch_known.any())
    overlap = np.array([ln.overlap_comm for ln in lanes], bool)

    # noise: z-draws + exp-multiplier tables, scalar-exact host-side
    noisy = np.zeros(W, bool)
    sigma_of = np.zeros((W, P))
    mu_of = np.zeros((W, P))
    draw_bound = np.zeros(W, np.int64)
    for b, ln in enumerate(lanes):
        if ln.noise is not None:
            noisy[b] = True
            for p in processors:
                s = ln.noise.sigma(p.kind)
                sigma_of[b, p.pid] = s
                mu_of[b, p.pid] = -0.5 * s * s
            draw_bound[b] = ln.num_requests * sum(
                ln.spec.counts[n] for nets in groups for n in nets)
    any_noise = bool(noisy.any())
    zcap = _bucket(int(draw_bound.max()) if any_noise else 1)
    emult = np.ones((W, zcap, P))
    for b in np.nonzero(noisy)[0]:
        rng = random.Random(lanes[b].noise.seed)
        bound = int(draw_bound[b])
        zs = [rng.gauss(0.0, 1.0) for _ in range(bound)]
        for p in pids:
            s = sigma_of[b, p]
            if s > 0.0:
                mu = mu_of[b, p]
                # the exact scalar expression: math.exp(mu + z * sigma)
                emult[b, :bound, p] = [math.exp(mu + z * s) for z in zs]

    # faults: straggler multipliers from the one-draw-per-delivery stream;
    # throttle/dropout windows as padded static tables
    faulted = np.zeros(W, bool)
    strag_on = np.zeros(W, bool)
    tmax = 1
    dmax_f = 1
    fb = np.zeros(W, np.int64)
    for b, ln in enumerate(lanes):
        if ln.faults is not None and not ln.faults.empty:
            faulted[b] = True
            tmax = max(tmax, len(ln.faults.throttles))
            dmax_f = max(dmax_f, len(ln.faults.dropouts))
            if ln.faults.straggler_prob > 0.0:
                strag_on[b] = True
                fb[b] = ln.num_requests * sum(
                    ln.spec.counts[n] for nets in groups for n in nets)
    any_fault = bool(faulted.any())
    any_strag = bool(strag_on.any())
    fcap = _bucket(int(fb.max()) if any_strag else 1)
    strag_tab = np.ones((W, fcap))
    thr_pid = np.full((W, tmax), -9, np.int64)
    thr_t0 = np.zeros((W, tmax))
    thr_t1 = np.zeros((W, tmax))
    thr_fac = np.ones((W, tmax))
    drop_pid = np.full((W, dmax_f), -9, np.int64)
    drop_t0 = np.zeros((W, dmax_f))
    drop_t1 = np.zeros((W, dmax_f))
    for b in np.nonzero(faulted)[0]:
        spec = lanes[b].faults
        for ti, (pid, t0, t1, fac) in enumerate(spec.throttles):
            thr_pid[b, ti] = pid
            thr_t0[b, ti], thr_t1[b, ti], thr_fac[b, ti] = t0, t1, fac
        for di, (pid, start, repair) in enumerate(spec.dropouts):
            drop_pid[b, di] = pid
            drop_t0[b, di] = start
            drop_t1[b, di] = (math.inf if repair is None
                              else start + repair)
        if strag_on[b]:
            rng = random.Random(spec.seed)
            prob = spec.straggler_prob
            inv_shape = 1.0 / spec.straggler_shape
            for k in range(int(fb[b])):
                u = rng.random()
                if u < prob:
                    # the exact scalar Pareto expression (FaultStream)
                    v = u / prob
                    if v >= 1.0:
                        v = math.nextafter(1.0, 0.0)
                    strag_tab[b, k] = (1.0 - v) ** (-inv_shape)
                else:
                    strag_tab[b, k] = 1.0

    idle0 = np.zeros(P, bool)
    idle0[pids] = True

    # FIFO classes: one per priority rank (dispatch tokens live in a
    # per-lane counter, not a ring). Ring capacity = exact bound on entries
    # ever pushed per (lane, pid, class): every push is a released task,
    # bounded by the lane's total task count across all requests.
    NP = int(prio_of.max()) + 1
    qbound = int((nr * group_tasks.sum(axis=1)).max())
    CAP = _bucket(qbound + 4)
    if CAP > QUEUE_CAP_MAX:
        note_fallback("queue-bound")
        return None

    # generous per-lane event bound: arrivals + completions (tasks +
    # dispatch tokens) + ring-head pops, doubled. Hitting it means a bug;
    # run_prepared raises instead of hanging.
    task_max = int(group_tasks.sum(axis=1).max())
    itercap = 64 + 2 * (G * (nr_max + 2) + 4 * nr_max * task_max)

    # shape bucketing as in the reference: pad W/S/NR (and the z/fault
    # tables, bucketed above). Padding lanes carry horizon -1: their
    # frontier (time 0) is never active, so they are inert.
    WB = max(16, -(-W // 16) * 16)
    SB = _bucket(S)
    NRB = _bucket(nr_max)
    jB = _bucket(jmax)
    dB = _bucket(dmax)
    if SB >= PACK_LIMIT or G * NRB >= PACK_LIMIT:
        # the ring payload packs (g + 1) << 21 | (rr + 1) into one word
        raise ValueError(f"{SB} subgraph slots or {G * NRB} request slots exceed "
                         f"the compiled tier's packing ({PACK_LIMIT})")

    def padw(a, fill=0):
        if a.shape[0] == WB:
            return a
        out = np.full((WB,) + a.shape[1:], fill, a.dtype)
        out[:W] = a
        return out

    def pad2(a, n, fill=0):
        if a.shape[1] == n:
            return a
        out = np.full((a.shape[0], n) + a.shape[2:], fill, a.dtype)
        out[:, :a.shape[1]] = a
        return out

    arrtab = np.zeros((W, G, NRB))
    arrtab[:, :, :arrtab_raw.shape[2]] = arrtab_raw
    succ_pad_b = np.zeros((W, SB, dB), np.int64)
    succ_pad_b[:, :S, :dmax] = succ_pad
    roots_b = np.zeros((W, G, jB), np.int64)
    roots_b[:, :, :jmax] = roots

    tab = {
        "arrtab": padw(arrtab),
        "horizon": padw(horizon, -1.0),
        "nr": padw(nr),
        "proc_of": padw(pad2(proc_of, SB)),
        "prio_of": padw(pad2(prio_of, SB)),
        "exec_v": padw(pad2(exec_v, SB)),
        "quant_v": padw(pad2(quant_v, SB)),
        "comm_v": padw(pad2(comm_v, SB)),
        "total_v": padw(pad2(total_v, SB)),
        "dep_cnt": padw(pad2(dep_cnt.astype(np.int32), SB)),
        "succ_pad": padw(succ_pad_b),
        "succ_cnt": padw(pad2(succ_cnt, SB)),
        "roots": padw(roots_b),
        "roots_n": padw(roots_n),
        "overlap": padw(overlap),
        "dispatch_ov": padw(dispatch_ov),
        "dispatch_pid": padw(dispatch_pid),
        "dispatch_known": padw(dispatch_known),
        "noisy": padw(noisy),
        "sigma_pos": padw(sigma_of > 0.0),
        "emult": padw(emult, 1.0),
        "faulted": padw(faulted),
        "strag_on": padw(strag_on),
        "strag_tab": padw(strag_tab, 1.0),
        "thr_pid": padw(thr_pid, -9),
        "thr_t0": padw(thr_t0),
        "thr_t1": padw(thr_t1),
        "thr_fac": padw(thr_fac, 1.0),
        "drop_pid": padw(drop_pid, -9),
        "drop_t0": padw(drop_t0),
        "drop_t1": padw(drop_t1),
        "idle0": idle0,
    }
    sizes = dict(W=WB, G=G, P=P, NP=NP, CAP=CAP, S=SB, NR=NRB, J=jB, DM=dB, ZC=zcap,
                 FC=fcap, T=tmax, D=dmax_f, any_noise=any_noise, any_fault=any_fault,
                 any_strag=any_strag, any_dispatch=any_dispatch, itercap=itercap)

    return PreparedBatch(packed=pack_tables(sizes, tab), sizes=sizes, lanes=lanes,
                         groups=groups, pids=pids, num_requests=nr, horizon=horizon,
                         group_tasks=group_tasks)


def run_prepared(prep: PreparedBatch, device: torch.device) -> object:
    """Advance a prepared batch on ``device`` and assemble its
    :class:`~repro_torch.core.batchsim.BatchResult`.

    Raises :class:`RuntimeError`, naming the lanes, when a FIFO ring
    overflowed or a lane reached the iteration cap: both are impossible by
    construction, so the loop that ran is wrong, and its answer is not
    replaced by another tier's.
    """
    from ..kernels.batchsim_advance import batchsim_advance
    from .batchsim import BatchResult

    # one transfer of the packed tables in
    (arrival, first_start, last_finish, done, busy, overflow, iters,
     _) = batchsim_advance(prep.packed.to(device), prep.sizes)
    W = len(prep.lanes)
    itercap = prep.sizes["itercap"]
    overflow, iters = overflow.cpu()[:W], iters.cpu()[:W]
    for flagged, why in ((overflow, "a FIFO ring overflowed"),
                         (iters >= itercap, f"reached the iteration cap {itercap}")):
        bad = torch.nonzero(flagged).flatten().tolist()
        if bad:
            raise RuntimeError(f"compiled batch tier on {device}: lanes {bad[:8]} of {W}: "
                               f"{why}; the event loop is at fault")
    with _STATS_LOCK:
        last_stats.clear()
        last_stats.update(iters=int(iters.max()), itercap=itercap, fallback=False)
    arrival, first_start, last_finish, done, busy = (
        a[:W].cpu().numpy() for a in (arrival, first_start, last_finish, done, busy))

    return BatchResult(
        lanes=prep.lanes, groups=prep.groups, num_requests=prep.num_requests,
        arrival=arrival, first_start=first_start, last_finish=last_finish,
        done=done, group_tasks=prep.group_tasks, busy=busy, horizon=prep.horizon,
        pids=prep.pids, nr_max=prep.sizes["NR"], tasks=None,
    )
