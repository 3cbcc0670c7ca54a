"""The compiled batch tier's event loop: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces the XLA-compiled ``jax.lax.while_loop`` of
``src/repro/core/batchsim_compiled.py`` (``_advance_factory``, :117): it
advances every lane of a batch of scheduler simulations to quiescence. The
host tables (:func:`repro_torch.core.batchsim_compiled.run_batch_compiled`
prepares them) travel as one packed buffer of 64-bit words, a header of
sizes and table offsets first (:data:`HEADER`, :data:`TABLES`), so a card
takes them in one transfer:

- on the card, ``csrc/batchsim_advance.cu``: one warp per lane runs that
  lane's whole event loop, the lane's event state in shared memory, the
  batch in one launch; its header says what bounds it;
- on the CPU, :func:`advance_plain`: the reference's lock-step pass in torch
  float64, every lane advanced one event per iteration by masked updates.

Both take the next event of a lane by the same ``(time, seq)`` key and
compute every float in IEEE double in the reference's operation order, with
no fused multiply-add, so they agree with the numpy ``BatchSimulator`` to
the last bit on every case the tests hold them to; the contract is
``COMPILED_REL_TOL``/``COMPILED_ABS_TOL``.

:func:`batchsim_advance` takes the packed buffer: on the CPU it runs
:func:`advance_plain`, on a CUDA tensor it launches the kernel or raises.
``batchsim_advance.launches`` counts kernel launches, under a lock. The
thread-per-lane kernel the warp design replaced stays in the same library,
reached only by :func:`_batchsim_advance_thread` for timing beside it.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .build import load_library

#: The packed buffer's header words, in the order the kernel reads them.
HEADER = ("W", "G", "P", "NP", "CAP", "S", "NR", "J", "DM", "ZC", "FC", "T", "D",
          "any_noise", "any_fault", "any_strag", "any_dispatch", "itercap")
#: The tables after the header (one offset word each, then the words), with
#: their element type and shape in header sizes. The kernel's ``Table``
#: enum has the same order.
TABLES = (
    ("arrtab", "f8", ("W", "G", "NR")), ("horizon", "f8", ("W",)), ("nr", "i8", ("W",)),
    ("proc_of", "i8", ("W", "S")), ("prio_of", "i8", ("W", "S")),
    ("exec_v", "f8", ("W", "S")), ("quant_v", "f8", ("W", "S")),
    ("comm_v", "f8", ("W", "S")), ("total_v", "f8", ("W", "S")),
    ("dep_cnt", "i8", ("W", "S")), ("succ_pad", "i8", ("W", "S", "DM")),
    ("succ_cnt", "i8", ("W", "S")), ("roots", "i8", ("W", "G", "J")),
    ("roots_n", "i8", ("W", "G")), ("overlap", "b", ("W",)),
    ("dispatch_ov", "f8", ("W",)), ("dispatch_pid", "i8", ("W",)),
    ("dispatch_known", "b", ("W",)), ("noisy", "b", ("W",)), ("sigma_pos", "b", ("W", "P")),
    ("emult", "f8", ("W", "ZC", "P")), ("faulted", "b", ("W",)), ("strag_on", "b", ("W",)),
    ("strag_tab", "f8", ("W", "FC")), ("thr_pid", "i8", ("W", "T")),
    ("thr_t0", "f8", ("W", "T")), ("thr_t1", "f8", ("W", "T")), ("thr_fac", "f8", ("W", "T")),
    ("drop_pid", "i8", ("W", "D")), ("drop_t0", "f8", ("W", "D")),
    ("drop_t1", "f8", ("W", "D")), ("idle0", "b", ("P",)),
)
#: Lanes (warps) a block of the kernel: the ``.cu``'s ``LANES_PER_BLOCK``.
LANES_PER_BLOCK = 2
#: The ring payload packs (g + 1) << 21 | (rr + 1) into one word.
PACK_LIMIT = 1 << 21
_BIGSEQ = 1 << 62
_LAUNCH_LOCK = threading.Lock()
Outputs = Tuple[torch.Tensor, ...]


def pack_tables(sizes: Dict[str, int], tab: Dict[str, np.ndarray]) -> torch.Tensor:
    """One int64 CPU tensor: the header, the table offsets, then every table's
    words (floats by their bits, booleans as 0/1)."""
    head = [int(sizes[k]) for k in HEADER]
    start = len(HEADER) + len(TABLES)
    offsets, words = [], []
    for name, kind, shape in TABLES:
        a = np.asarray(tab[name])
        want = tuple(int(sizes[d]) for d in shape)
        if a.shape != want:
            raise ValueError(f"table {name}: shape {a.shape}, want {want}")
        if kind == "f8":
            w = np.ascontiguousarray(a, np.float64).view(np.int64)
        else:
            w = np.ascontiguousarray(a).astype(np.int64)
        offsets.append(start + sum(x.size for x in words))
        words.append(w.reshape(-1))
    return torch.from_numpy(np.concatenate([np.array(head + offsets, np.int64)] + words))


def unpack_tables(packed: torch.Tensor) -> Tuple[Dict[str, int], Dict[str, torch.Tensor]]:
    """The sizes and the tables of a packed buffer, as views on its device."""
    nh = len(HEADER)
    head = packed[:nh + len(TABLES)].tolist()
    sizes = dict(zip(HEADER, head[:nh]))
    tab: Dict[str, torch.Tensor] = {}
    for (name, kind, shape), off in zip(TABLES, head[nh:]):
        dims = tuple(sizes[d] for d in shape)
        n = int(np.prod(dims))
        w = packed[off:off + n].view(dims)
        tab[name] = w.view(torch.float64) if kind == "f8" else (w != 0 if kind == "b" else w)
    return sizes, tab


def advance_plain(flags: Sequence, tab: Dict[str, torch.Tensor]) -> Outputs:
    """The lock-step pass in torch float64: every lane advances one event per
    iteration, each handler a masked update over all lanes. A translation of
    the reference's ``_advance_factory`` body.

    ``flags`` is ``(G, P, NP, CAP, any_noise, any_fault, any_strag,
    any_dispatch)``; ``tab`` holds the tables of :data:`TABLES` and
    ``itercap``. Returns ``(arrival, first_start, last_finish, done, busy,
    overflow, iters, pushes)``: the per-request and per-processor arrays,
    then per lane whether a FIFO ring overflowed, the events run and the
    tasks pushed into its rings.
    """
    (G, P, NP, CAP, any_noise, any_fault, any_strag, any_dispatch) = flags
    arrtab = tab["arrtab"]
    dev = arrtab.device
    W, _, NR = arrtab.shape
    S = tab["exec_v"].shape[1]
    R = G * NR
    C = G + P + 1
    K = P + 1
    jmax = tab["roots"].shape[2]
    dmax = tab["succ_pad"].shape[2]
    horizon, nr = tab["horizon"], tab["nr"]
    proc_of, prio_of = tab["proc_of"], tab["prio_of"]
    exec_v, quant_v, comm_v, total_v = (tab[k] for k in ("exec_v", "quant_v", "comm_v",
                                                         "total_v"))
    dep_cnt = tab["dep_cnt"].to(torch.int32)
    succ_pad, succ_cnt = tab["succ_pad"], tab["succ_cnt"]
    roots, roots_n = tab["roots"], tab["roots_n"]
    overlap, dispatch_ov = tab["overlap"], tab["dispatch_ov"]
    dispatch_pid, dispatch_known = tab["dispatch_pid"], tab["dispatch_known"]
    noisy, sigma_pos, emult = tab["noisy"], tab["sigma_pos"], tab["emult"]
    faulted, strag_on, strag_tab = tab["faulted"], tab["strag_on"], tab["strag_tab"]
    thr_pid, thr_t0, thr_t1, thr_fac = (tab[k] for k in ("thr_pid", "thr_t0", "thr_t1",
                                                         "thr_fac"))
    drop_pid, drop_t0, drop_t1 = tab["drop_pid"], tab["drop_t0"], tab["drop_t1"]
    idle0 = tab["idle0"]
    itercap = int(tab["itercap"])
    ZC, FC = emult.shape[1], strag_tab.shape[1]
    T, D = thr_pid.shape[1], drop_pid.shape[1]
    i64, f64 = torch.int64, torch.float64
    WI = torch.arange(W, device=dev)
    INF = float("inf")
    M21 = (1 << 21) - 1

    def ar(n):
        return torch.arange(n, device=dev)

    def full(shape, v, dtype=i64):
        return torch.full(shape, v, dtype=dtype, device=dev)

    # one-hot masked updates, as the reference writes them
    def oh(m, col, width):
        return m[:, None] & (col[:, None] == ar(width)[None, :])

    def oh_set(arr, m, col, val):
        o = oh(m, col, arr.shape[1])
        v = val[:, None] if torch.is_tensor(val) and val.dim() else val
        return torch.where(o, v, arr)

    def oh2(m, i, j2, d1, d2):
        return (m[:, None, None] & (i[:, None, None] == ar(d1)[None, :, None])
                & (j2[:, None, None] == ar(d2)[None, None, :]))

    def set_col(arr, col, m, val):
        arr = arr.clone()
        arr[:, col] = torch.where(m, val, arr[:, col])
        return arr

    def append_deliver(st, m, pid, g, rr, t):
        st["idle"] = st["idle"] & ~oh(m, pid, P)
        pos = st["del_n"]
        pack = ((pid + 1) << 42) | ((g + 1) << 21) | (rr + 1)
        st["del_pack"] = oh_set(st["del_pack"], m, pos, pack)
        we = m & (pos == 0)
        st["times"] = set_col(st["times"], C - 1, we, t)
        st["seqs"] = set_col(st["seqs"], C - 1, we, st["seq"])
        st["del_n"] = st["del_n"] + m
        st["seq"] = st["seq"] + m
        return st

    def queue_push(st, m, pid, cls, g, rr):
        """Append to the (pid, cls) FIFO ring; order = push order = the numpy
        tier's packed-key order."""
        pid_c = pid.clamp(0, P - 1)
        pos = st["ftail"][WI, pid_c, cls]
        head = st["fhead"][WI, pid_c, cls]
        st["overflow"] = st["overflow"] | (m & (pos - head >= CAP))
        idx = pos & (CAP - 1)
        st["fifo"][WI[m], pid[m], cls[m], idx[m]] = (((g + 1) << 21) | (rr + 1))[m]
        st["ftail"] = st["ftail"] + oh2(m, pid, cls, P, NP)
        return st

    def release(st, m, g, rr, t):
        """Reference ``release()``: dispatch token, then the task. Tokens
        queue only on the lane's ``dispatch_pid``, so their FIFO is a
        counter."""
        if not bool(m.any()):
            return st
        neg1 = full((W,), -1)
        if any_dispatch:
            dm = m & dispatch_known
            st["rel_seq"] = st["rel_seq"] + dm
            d_idle = st["idle"][WI, dispatch_pid]
            st = append_deliver(st, dm & d_idle, dispatch_pid, neg1, neg1, t)
            st["tok"] = st["tok"] + (dm & ~d_idle)
        st["rel_seq"] = st["rel_seq"] + m
        g_c = g.clamp(0, S - 1)
        pid = proc_of[WI, g_c]
        is_idle = st["idle"][WI, pid]
        st = append_deliver(st, m & is_idle, pid, g, rr, t)
        return queue_push(st, m & ~is_idle, pid, prio_of[WI, g_c], g, rr)

    def pull_next(st, m, pid, t):
        """Pop queued dispatch tokens first (class 0), else the head of the
        first non-empty priority FIFO."""
        pid_c = pid.clamp(0, P - 1)
        if any_dispatch:
            tok_has = m & (pid == dispatch_pid) & (st["tok"] > 0)
            st["tok"] = st["tok"] - tok_has.long()
        else:
            tok_has = torch.zeros(W, dtype=torch.bool, device=dev)
        heads = st["fhead"][WI, pid_c]
        tails = st["ftail"][WI, pid_c]
        nonempty = heads < tails
        sel = torch.argmax(nonempty.to(torch.int8), dim=1)
        fifo_has = m & ~tok_has & nonempty.any(dim=1)
        head_sel = torch.gather(heads, 1, sel[:, None])[:, 0]
        v = st["fifo"][WI, pid_c, sel, head_sel & (CAP - 1)]
        g = torch.where(tok_has, -1, ((v >> 21) & M21) - 1)
        rr = torch.where(tok_has, -1, (v & M21) - 1)
        st["fhead"] = st["fhead"] + oh2(fifo_has, pid, sel, P, NP)
        has = tok_has | fifo_has
        st = append_deliver(st, has, pid, g, rr, t)
        st["idle"] = st["idle"] | oh(m & ~has, pid, P)
        return st

    def body(st, tmin):
        """One event of every active lane. A handler whose mask holds no
        lane is skipped: its masked updates would change nothing."""
        smask = torch.where(st["times"] == tmin[:, None], st["seqs"], _BIGSEQ)
        ci = torch.argmin(smask, dim=1)
        act = tmin <= horizon
        t = tmin
        mA = act & (ci < G)
        if bool(mA.any()):
            st = arrivals(st, mA, ci, t)
        mC = act & (ci >= G) & (ci < G + P)
        if bool(mC.any()):
            st = completions(st, mC, ci, t)
        mD = act & (ci == C - 1)
        if bool(mD.any()):
            st = drain(st, mD, t)
        st["it"] = st["it"] + act
        return st

    def arrivals(st, mA, ci, t):
        gid = torch.where(mA, ci, 0)
        rid = st["src_rid"][WI, gid]
        a0 = arrtab[WI, gid, 0]
        defer = mA & (rid == 0) & (a0 > t)
        st["times"] = oh_set(st["times"], defer, gid, t + (a0 - t))
        st["seqs"] = oh_set(st["seqs"], defer, gid, st["seq"])
        st["seq"] = st["seq"] + defer
        arr_m = mA & ~defer
        rr = gid * NR + rid
        st["arrival"] = torch.where(oh(arr_m, rr, R), t[:, None], st["arrival"])
        st["pend"][WI[arr_m], rr[arr_m]] = dep_cnt[arr_m]
        for j in range(jmax):
            mj = arr_m & (j < roots_n[WI, gid])
            if not bool(mj.any()):
                break
            st = release(st, mj, roots[WI, gid, j], rr, t)
        nrid = rid + 1
        has = arr_m & (nrid < nr)
        arr_next = arrtab[WI, gid, nrid.clamp(max=NR - 1)]
        st["times"] = oh_set(st["times"], arr_m, gid,
                             torch.where(has, t + (arr_next - t), INF))
        st["seqs"] = oh_set(st["seqs"], arr_m, gid, torch.where(has, st["seq"], _BIGSEQ))
        st["seq"] = st["seq"] + has
        st["src_rid"] = oh_set(st["src_rid"], has, gid, nrid)
        return st

    def completions(st, mC, ci, t):
        pid = (ci - G).clamp(0, P - 1)
        g = st["end_g"][WI, pid]
        rr = st["end_rr"][WI, pid]
        real = mC & (g >= 0)
        o_r = oh(real, rr, R)
        st["done"] = st["done"] + o_r
        st["last_finish"] = torch.where(o_r, torch.maximum(st["last_finish"], t[:, None]),
                                        st["last_finish"])
        g_c = g.clamp(0, S - 1)
        rr_c = rr.clamp(0, R - 1)
        for j in range(dmax):
            mj = real & (j < succ_cnt[WI, g_c])
            if not bool(mj.any()):
                break
            sj = succ_pad[WI, g_c, j]
            pj = st["pend"][WI, rr_c, sj] - 1
            st["pend"][WI[mj], rr[mj], sj[mj]] = pj[mj]
            st = release(st, mj & (pj == 0), sj, rr, t)
        st["times"] = oh_set(st["times"], mC, G + pid, INF)
        st["seqs"] = oh_set(st["seqs"], mC, G + pid, _BIGSEQ)
        st["end_g"] = oh_set(st["end_g"], mC, pid, -2)
        return pull_next(st, mC, pid, t)

    def drain(st, mD, t):
        """The delivery ring, all K slots at once."""
        # Sound because every slot shares the drain's timestamp, a pid is
        # in the ring at most once (so per-pid and per-column writes never
        # collide), and the slot-order-dependent state (the seq counter,
        # the noise and straggler cursors) is rebuilt with exclusive prefix
        # counts over the slots.
        mk = mD[:, None] & (ar(K)[None, :] < st["del_n"][:, None])
        v = st["del_pack"]
        pidj = (v >> 42) - 1
        gj = ((v >> 21) & M21) - 1
        rrj = (v & M21) - 1
        pid_c = pidj.clamp(0, P - 1)
        gj_c = gj.clamp(0, S - 1)
        disp = mk & (gj < 0)
        realm = mk & (gj >= 0)
        WK = WI[:, None]
        tK = t[:, None]
        mkl = mk.long()
        seq_at = st["seq"][:, None] + (torch.cumsum(mkl, 1) - mkl)
        st["seq"] = st["seq"] + mkl.sum(1)
        exec_t = exec_v[WK, gj_c]
        total = total_v[WK, gj_c]
        cm = torch.where(overlap[:, None], 0.0, comm_v[WK, gj_c])
        if any_noise:
            draw = realm & noisy[:, None] & sigma_pos[WK, pid_c]
            dl = draw.long()
            zat = st["zpos"][:, None] + (torch.cumsum(dl, 1) - dl)
            mult = emult[WK, zat.clamp(max=ZC - 1), pid_c]
            st["zpos"] = st["zpos"] + dl.sum(1)
            et = exec_t * mult
            # the scalar loop's order: exec + quant + (0 | comm)
            tt = et + quant_v[WK, gj_c] + cm
            exec_t = torch.where(draw, et, exec_t)
            total = torch.where(draw, tt, total)
        if any_fault:
            fm = realm & faulted[:, None]
            ex_f = exec_t
            if any_strag:
                sd = fm & strag_on[:, None]
                sdl = sd.long()
                fat = st["fpos"][:, None] + (torch.cumsum(sdl, 1) - sdl)
                sm = strag_tab[WK, fat.clamp(max=FC - 1)]
                st["fpos"] = st["fpos"] + sdl.sum(1)
                ex_f = torch.where(sd, ex_f * sm, ex_f)
            for ti in range(T):
                match = (fm & (thr_pid[:, ti, None] == pidj) & (thr_t0[:, ti, None] <= tK)
                         & (tK < thr_t1[:, ti, None]))
                ex_f = torch.where(match, ex_f * thr_fac[:, ti, None], ex_f)
            stall = torch.zeros((W, K), dtype=f64, device=dev)
            found = torch.zeros((W, K), dtype=torch.bool, device=dev)
            for di in range(D):
                match = (fm & ~found & (drop_pid[:, di, None] == pidj)
                         & (drop_t0[:, di, None] <= tK) & (tK < drop_t1[:, di, None]))
                stall = torch.where(match, drop_t1[:, di, None] - tK, stall)
                found = found | match
            tt = ex_f + quant_v[WK, gj_c] + cm
            tt = torch.where(stall > 0.0, stall + tt, tt)
            exec_t = torch.where(fm, ex_f, exec_t)
            total = torch.where(fm, tt, total)
        ohr = realm[:, :, None] & (rrj[:, :, None] == ar(R)[None, None, :])
        st["first_start"] = torch.where(ohr.any(1), torch.minimum(st["first_start"], tK),
                                        st["first_start"])
        fin = realm & torch.isfinite(total)
        ohp = (disp | realm)[:, :, None] & (pid_c[:, :, None] == ar(P)[None, None, :])
        badd = torch.where(disp, dispatch_ov[:, None], torch.where(fin, total, 0.0))
        st["busy"] = st["busy"] + torch.where(ohp, badd[:, :, None], 0.0).sum(1)
        ohc = (disp | realm)[:, :, None] & ((G + pid_c)[:, :, None] == ar(C)[None, None, :])
        tval = torch.where(disp, tK + dispatch_ov[:, None], tK + total)
        hitc = ohc.any(1)
        st["times"] = torch.where(hitc, torch.where(ohc, tval[:, :, None], 0.0).sum(1),
                                  st["times"])
        st["seqs"] = torch.where(hitc, torch.where(ohc, seq_at[:, :, None], 0).sum(1),
                                 st["seqs"])
        hitp = ohp.any(1)
        egv = torch.where(disp, -1, gj)
        st["end_g"] = torch.where(hitp, torch.where(ohp, egv[:, :, None], 0).sum(1),
                                  st["end_g"])
        ohpr = realm[:, :, None] & (pid_c[:, :, None] == ar(P)[None, None, :])
        st["end_rr"] = torch.where(ohpr.any(1), torch.where(ohpr, rrj[:, :, None], 0).sum(1),
                                   st["end_rr"])
        st["del_n"] = torch.where(mD, 0, st["del_n"])
        st["times"] = set_col(st["times"], C - 1, mD, torch.full_like(t, INF))
        st["seqs"] = set_col(st["seqs"], C - 1, mD, full((W,), _BIGSEQ))
        return st

    times0 = torch.full((W, C), INF, dtype=f64, device=dev)
    times0[:, :G] = 0.0
    seqs0 = full((W, C), _BIGSEQ)
    seqs0[:, :G] = ar(G)[None, :]
    st = {
        "times": times0, "seqs": seqs0, "seq": full((W,), G), "rel_seq": full((W,), 0),
        "src_rid": full((W, G), 0), "idle": idle0[None, :].expand(W, P).clone(),
        "end_g": full((W, P), -2), "end_rr": full((W, P), -1),
        "arrival": torch.zeros((W, R), dtype=f64, device=dev),
        "first_start": torch.full((W, R), INF, dtype=f64, device=dev),
        "last_finish": torch.zeros((W, R), dtype=f64, device=dev),
        "done": full((W, R), 0), "pend": full((W, R, S), 0, torch.int32),
        "busy": torch.zeros((W, P), dtype=f64, device=dev),
        "fifo": full((W, P, NP, CAP), 0), "fhead": full((W, P, NP), 0),
        "ftail": full((W, P, NP), 0), "tok": full((W,), 0), "del_pack": full((W, K), 0),
        "del_n": full((W,), 0), "zpos": full((W,), 0), "fpos": full((W,), 0),
        "overflow": full((W,), False, torch.bool), "it": full((W,), 0),
    }
    n = 0
    while n < itercap and not bool(st["overflow"].any()):
        tmin = st["times"].amin(dim=1)
        if not bool((tmin <= horizon).any()):
            break
        st = body(st, tmin)
        n += 1
    return (st["arrival"], st["first_start"], st["last_finish"], st["done"], st["busy"],
            st["overflow"], st["it"], st["ftail"].sum(dim=(1, 2)))


def batchsim_advance(packed: torch.Tensor,
                     sizes: Optional[Dict[str, int]] = None) -> Outputs:
    """Advance every lane of a packed batch to quiescence.

    A CPU buffer runs :func:`advance_plain`; a CUDA buffer launches the
    kernel, one warp per lane, or raises. ``sizes`` is the buffer's
    header as the host packed it (read from the buffer when not given).
    Returns ``(arrival, first_start, last_finish, done, busy, overflow,
    iters, pushes)`` on the buffer's device, as :func:`advance_plain`
    describes them.
    """
    if packed.dtype != torch.int64 or packed.dim() != 1:
        raise ValueError("want the 1-D int64 buffer of pack_tables")
    if not packed.is_cuda:
        if packed.device.type != "cpu":
            raise ValueError(f"unsupported device {packed.device}")
        sizes, tab = unpack_tables(packed)
        tab["itercap"] = torch.tensor(sizes["itercap"])
        return advance_plain(flags_of(sizes), tab)
    if sizes is None:
        sizes = dict(zip(HEADER, packed[:len(HEADER)].tolist()))
    return _launch(packed.contiguous(), sizes)


def flags_of(sizes: Dict[str, int]) -> Tuple:
    """The plain pass's static ``flags`` from the header sizes."""
    return (sizes["G"], sizes["P"], sizes["NP"], sizes["CAP"], bool(sizes["any_noise"]),
            bool(sizes["any_fault"]), bool(sizes["any_strag"]), bool(sizes["any_dispatch"]))


def scratch_words(sizes: Dict[str, int]) -> int:
    """The kernel's scratch in 64-bit words: the pending-dependency counters
    and the FIFO rings, each lane's contiguous."""
    return int(_lib().batchsim_advance_scratch_words(*_scratch_args(sizes)))


def shared_words(G: int, P: int, NP: int) -> int:
    """One lane's mutable event state in the kernel's shared memory, in
    64-bit words: the frontier's times and seqs (C = G + P + 1 each), busy,
    src_rid, idle, end_g and end_rr, the delivery ring (P + 1) and the FIFO
    heads and tails (P x NP each)."""
    C = G + P + 1
    return 2 * C + P + G + 3 * P + (P + 1) + 2 * P * NP


def shared_bytes(sizes: Dict[str, int]) -> int:
    """The dynamic shared memory a block of the kernel needs, in bytes."""
    return 8 * LANES_PER_BLOCK * shared_words(sizes["G"], sizes["P"], sizes["NP"])


def _scratch_args(sizes: Dict[str, int]):
    return [int(sizes[k]) for k in ("W", "G", "P", "NP", "CAP", "S", "NR")]


def _outputs(packed: torch.Tensor, sizes: Dict[str, int]) -> torch.Tensor:
    W, P, R = sizes["W"], sizes["P"], sizes["G"] * sizes["NR"]
    if W >= 2**31:
        raise ValueError(f"{W} lanes exceed the kernel's int lane count")
    return torch.empty(4 * W * R + W * P + 3 * W, dtype=torch.int64, device=packed.device)


def _views(out: torch.Tensor, sizes: Dict[str, int]) -> Outputs:
    W, P, R = sizes["W"], sizes["P"], sizes["G"] * sizes["NR"]
    wr = W * R
    f = out.view(torch.float64)
    flags = out[4 * wr + W * P:].view(3, W)
    return (f[:wr].view(W, R), f[wr:2 * wr].view(W, R), f[2 * wr:3 * wr].view(W, R),
            out[3 * wr:4 * wr].view(W, R), f[4 * wr:4 * wr + W * P].view(W, P),
            flags[0] != 0, flags[1], flags[2])


def _check(lib: ctypes.CDLL, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.batchsim_advance_error_string(err).decode()} ({err})")


def _launch(packed: torch.Tensor, sizes: Dict[str, int]) -> Outputs:
    lib = _lib()
    nbytes = shared_bytes(sizes)
    limit = _shared_limit(packed.get_device())
    if nbytes > limit:
        raise ValueError(
            f"batchsim_advance needs {nbytes} bytes of shared memory a block "
            f"({LANES_PER_BLOCK} lanes of G {sizes['G']}, P {sizes['P']}, NP {sizes['NP']}); "
            f"the card allows {limit}")
    out = _outputs(packed, sizes)
    scratch = torch.empty(scratch_words(sizes), dtype=torch.int64, device=packed.device)
    stream = torch._C._cuda_getCurrentRawStream(packed.get_device())
    _check(lib, lib.batchsim_advance(packed.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                                     sizes["W"], nbytes, stream), "batchsim_advance")
    with _LAUNCH_LOCK:
        batchsim_advance.launches += 1
    return _views(out, sizes)


batchsim_advance.launches = 0


def _batchsim_advance_thread(packed: torch.Tensor, sizes: Dict[str, int]) -> Outputs:
    """The thread-per-lane kernel the warp-per-lane design replaced, on a
    CUDA buffer, for timing beside :func:`batchsim_advance` only: the same
    outputs, its own scratch (its lane-minor state first). Nothing in the
    port calls it."""
    if not packed.is_cuda:
        raise ValueError("the thread-per-lane kernel takes a CUDA buffer")
    lib = _lib()
    out = _outputs(packed, sizes)
    words = int(lib.batchsim_advance_thread_scratch_words(*_scratch_args(sizes)))
    scratch = torch.empty(words, dtype=torch.int64, device=packed.device)
    stream = torch._C._cuda_getCurrentRawStream(packed.get_device())
    _check(lib, lib.batchsim_advance_thread(packed.data_ptr(), out.data_ptr(),
                                            scratch.data_ptr(), sizes["W"], stream),
           "batchsim_advance_thread")
    with _LAUNCH_LOCK:
        _batchsim_advance_thread.launches += 1
    return _views(out, sizes)


_batchsim_advance_thread.launches = 0


@functools.lru_cache(maxsize=None)
def _shared_limit(device: int) -> int:
    lib = _lib()
    limit = ctypes.c_int(0)
    _check(lib, lib.batchsim_advance_shared_limit(device, ctypes.byref(limit)),
           "cudaDeviceGetAttribute")
    return limit.value


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("batchsim_advance")
    # tab, out, scratch, lanes, shared bytes, stream
    lib.batchsim_advance.argtypes = ([ctypes.c_void_p] * 3
                                     + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
    lib.batchsim_advance.restype = ctypes.c_int
    # tab, out, scratch, lanes, stream
    lib.batchsim_advance_thread.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                                    ctypes.c_void_p]
    lib.batchsim_advance_thread.restype = ctypes.c_int
    for fn in (lib.batchsim_advance_scratch_words, lib.batchsim_advance_thread_scratch_words):
        fn.argtypes = [ctypes.c_int] * 7
        fn.restype = ctypes.c_longlong
    lib.batchsim_advance_shared_limit.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.batchsim_advance_shared_limit.restype = ctypes.c_int
    lib.batchsim_advance_error_string.argtypes = [ctypes.c_int]
    lib.batchsim_advance_error_string.restype = ctypes.c_char_p
    return lib
