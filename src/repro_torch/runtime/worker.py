"""Worker: one per processor, non-preemptive execution (paper §5.1); port
of ``repro.runtime.worker``.

Each Worker owns a priority task queue. In real-execution mode it runs two
threads: a (de)quantization thread and an execution thread, connected by an
internal queue — so staging of the next task overlaps execution of the
current one, exactly the two-thread design in Fig. 9. On the card each
Worker owns one CUDA stream and both of its threads issue their work on it,
so the Workers of the three "processors" run at the same time on the one
card.

In **virtual-clock mode** (``cost_source`` given) the Worker spawns no
threads, makes no stream and touches no tensor: it keeps a priority heap of
waiting items and cooperates with a
:class:`~repro_torch.runtime.clock.VirtualClock` — a submitted task is
*delivered* (costs charged, noise drawn) and *ended* (dependents resolved)
through scheduled events, reproducing the simulator's deliver/end event
structure one-to-one. This makes a runtime execution a deterministic,
instant replay whose task trace is bit-comparable to
:class:`~repro_torch.core.fastsim.FastSimulator`.

The dtype boundary keeps the reference's behaviour by default: an input
whose producer's dtype differs from the subgraph's is copied as float32
through a pooled staging buffer, any other goes through the transport.
With ``int8_staging`` every boundary input of an ``int8`` subgraph is
instead quantized row-wise to int8 and dequantized into a pooled buffer in
the subgraph's compute dtype (bf16): the job the int8 quantizer kernel has
in the paper's Worker. The NHWC tensor (N, H, W, C) is seen as (N·H, W·C)
rows, without a copy.
"""
from __future__ import annotations

import contextlib
import heapq
import math
import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..kernels import ops
from .clock import SimCostSource, WallClock
from .engine import Engine
from .recovery import RecoveryPolicy
from .tensorpool import SharedBufferTransport, TensorPool


class WorkerExecutionError(RuntimeError):
    """A task failed inside a Worker thread (staging or execution).

    Carries enough context — subgraph, processor, backend, original
    exception — for the client to tell *which placement* broke. Raised into
    the owning request's future only; the worker threads keep serving."""


@dataclass(order=True)
class WorkerTask:
    priority: Tuple
    payload: Any = field(compare=False)


#: The zoo computes an int8 subgraph in bf16; int8 staging dequantizes into it.
_INT8_COMPUTE_DTYPE = torch.bfloat16

#: Stop sentinel. Its priority ``(-2,)`` sorts below every real key — task
#: keys are ``(0, prio, seq)`` and dispatch tokens ``(-1, 0, seq)`` — so a
#: stop request jumps the queue even when tasks are still pending (the
#: abandoned-mid-request case).
_STOP = object()

#: Virtual-mode dispatch token: the Coordinator's per-release dispatch work
#: occupying the dispatch processor (paper §6.3), mirroring the simulators'
#: sentinel store item.
DISPATCH_TOKEN = ("dispatch",)


class Worker:
    """Dedicated executor for one processor id."""

    def __init__(
        self,
        pid: int,
        name: str,
        engines: Dict[str, Engine],
        pool: TensorPool,
        transport: SharedBufferTransport,
        on_done: Callable[[Any, Any, float, float], None],
        clock=None,
        cost_source: Optional[SimCostSource] = None,
        on_start: Optional[Callable[[Any], None]] = None,
        recovery: Optional[RecoveryPolicy] = None,
        on_stalled: Optional[Callable[[int, Any], None]] = None,
        on_recovery: Optional[Callable[[str, int, Dict], None]] = None,
        device: Optional[torch.device] = None,
        int8_staging: bool = False,
    ):
        self.pid = pid
        self.name = name
        self.engines = engines
        self.pool = pool
        self.transport = transport
        self.on_done = on_done
        self.on_start = on_start
        # virtual-mode recovery: policy knobs + runtime hooks (None = serve
        # faults raw, the parity-oracle setting)
        self.recovery = recovery
        self.on_stalled = on_stalled
        self.on_recovery = on_recovery
        self.clock = clock if clock is not None else WallClock()
        self.cost_source = cost_source
        self.virtual = cost_source is not None
        self.int8_staging = int8_staging
        self.stream = (torch.cuda.Stream(device)
                       if not self.virtual and device is not None
                       and device.type == "cuda" else None)
        self._queue: "queue.PriorityQueue[WorkerTask]" = queue.PriorityQueue()
        self._exec_queue: "queue.Queue[Optional[Tuple]]" = queue.Queue(maxsize=4)
        self._quant_thread = threading.Thread(target=self._quant_loop, daemon=True)
        self._exec_thread = threading.Thread(target=self._exec_loop, daemon=True)
        self.busy_time = 0.0
        self.tasks_done = 0
        self._stop = False
        # virtual-mode state: waiting-item heap + idle flag, exactly the
        # simulator's per-processor store
        self._vstore: List[Tuple[Tuple, Any]] = []
        self._vidle = True

    def start(self) -> None:
        if self.virtual:
            return  # no threads: the VirtualClock drives everything
        self._quant_thread.start()
        self._exec_thread.start()

    def submit(self, priority: Tuple, payload: Any) -> None:
        if self.virtual:
            if self._vidle:
                self._vidle = False
                self.clock.schedule(0.0, lambda: self._vdeliver(payload))
            else:
                heapq.heappush(self._vstore, (priority, payload))
            return
        self._queue.put(WorkerTask(priority, payload))

    def stop(self, join: bool = True, timeout: float = 10.0) -> None:
        """Stop the worker; with ``join`` (default) wait for both threads.

        Safe to call with tasks still queued (the stop sentinel outranks
        them) and idempotent. After a joined stop no worker thread is alive
        and both queues are drained.
        """
        if self.virtual:
            self._stop = True
            self._vstore.clear()  # drop waiting items: the clock is done
            return
        if not self._stop:
            self._stop = True
            self._queue.put(WorkerTask((-2,), _STOP))
        if join:
            for t in (self._quant_thread, self._exec_thread):
                if t.ident is not None:
                    t.join(timeout)
            self._drain()

    def threads_alive(self) -> bool:
        return self._quant_thread.is_alive() or self._exec_thread.is_alive()

    def _drain(self) -> None:
        for q in (self._queue, self._exec_queue):
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    # -- virtual-clock execution ----------------------------------------------
    def _vdeliver(self, payload: Any) -> None:
        """Task delivery event: charge costs, draw noise, schedule the end.

        Mirrors the simulator's DELIVER event byte for byte: the noise draw
        happens here (global delivery order), ``busy_time`` accrues the full
        service time up front, and the end event fires at ``now + total``
        with ``total = exec + quant + comm`` in that association.
        """
        src = self.cost_source
        if payload is DISPATCH_TOKEN:
            ov = src.dispatch_overhead
            self.busy_time += ov
            self.clock.schedule(ov, self._vpull)
            return
        comm, quant, exec_t = src.costs(payload["net"], payload["sg"])
        clean_total = exec_t + quant + comm  # pre-noise, pre-fault estimate
        exec_t = src.noisy_exec(self.pid, exec_t)
        stall = 0.0
        if src.fault_stream is not None:
            exec_t, stall = src.fault_stream.service(
                self.pid, self.clock.now(), exec_t)
        pol = self.recovery
        if pol is not None and math.isinf(stall) and self.on_stalled is not None:
            # delivered onto a permanently-dead processor with recovery on:
            # hand the task back for re-routing instead of stalling forever,
            # then keep draining the queue (the reroute cannot come back —
            # the runtime rewires the placement before redispatching)
            self.on_stalled(self.pid, payload)
            self._vpull()
            return
        payload["started"] = self.clock.now()
        payload["comm_s"] = comm
        payload["quant_s"] = quant
        payload["exec_s"] = exec_t
        if self.on_start is not None:
            self.on_start(payload)
        total = exec_t + quant + comm
        if stall > 0.0:
            # delivered to a dropped processor: stall until the repair (an
            # end event at t=inf never fires — same drop semantics as the
            # simulator tiers)
            payload["stall_s"] = stall
            total = stall + total
        if pol is not None and stall == 0.0:
            # straggler watchdog — stall time is excluded: retrying into a
            # dead/throttled-window processor cannot help, the remap can
            timeout_s = pol.timeout_for(clean_total)
            attempts = payload.get("attempts", 0)
            if total > timeout_s and attempts < pol.max_retries:
                # abandon the attempt at the timeout, re-deliver after a
                # linear backoff; the retry re-draws the noise and fault
                # streams (recovery runs are not parity-compared)
                payload["attempts"] = attempts + 1
                self.busy_time += timeout_s
                if self.on_recovery is not None:
                    self.on_recovery("retry", self.pid, {
                        "net": payload["net"], "sg": payload["sg"],
                        "request": payload["request"],
                        "attempt": attempts + 1,
                        "timeout_s": timeout_s, "total_s": total,
                    })
                self.clock.schedule(timeout_s + pol.backoff * (attempts + 1),
                                    lambda: self._vdeliver(payload))
                return
        if not math.isinf(total):
            self.busy_time += total
        self.clock.schedule(total, lambda: self._vend(payload))

    def _vend(self, payload: Any) -> None:
        """Task end event: resolve dependents, then pull the next item."""
        self.tasks_done += 1
        # the Coordinator releases ready successors *before* this worker
        # pulls its next item — same order as the simulator's END event
        self.on_done(payload, None, payload["quant_s"], payload["exec_s"])
        self._vpull()

    def _vpull(self) -> None:
        if self._vstore:
            _, payload = heapq.heappop(self._vstore)
            self.clock.schedule(0.0, lambda: self._vdeliver(payload))
        else:
            self._vidle = True

    # -- real execution -------------------------------------------------------
    def _on_stream(self):
        """Issue the calling thread's work on this Worker's stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _wrap_error(self, payload: Any, stage: str,
                    e: Exception) -> WorkerExecutionError:
        return WorkerExecutionError(
            f"{stage} failed for subgraph (net={payload.get('net')}, "
            f"sg={payload.get('sg')}) on processor {self.pid} ({self.name}), "
            f"backend={payload.get('backend')!r}: {type(e).__name__}: {e}")

    def _stage_int8(self, x: torch.Tensor) -> torch.Tensor:
        """int8 round trip of ``x`` into a pooled bf16 buffer of its shape:
        one K1 launch writes q, scale and the dequantized rows."""
        rows = x.reshape(math.prod(x.shape[:2]), -1)
        out = self.pool.acquire(tuple(x.shape), _INT8_COMPUTE_DTYPE)
        ops.quantize_rows(rows, out=out.view(rows.shape))
        return out

    # -- dequant/staging thread ---------------------------------------------
    def _quant_loop(self) -> None:
        with self._on_stream():
            while True:
                task = self._queue.get()
                if task.payload is _STOP:
                    self._exec_queue.put(None)
                    return
                payload = task.payload
                t0 = self.clock.now()
                inputs = payload.get("inputs")
                prepared: List = []
                pooled: List[bool] = []
                err: Optional[Exception] = None
                try:
                    if inputs is not None:
                        want = payload["dtype"]
                        for tensor, src_dtype in inputs:
                            # dtype boundary: (de)quantize through a pooled
                            # staging buffer (the Worker dequant path)
                            if self.int8_staging and want == "int8":
                                prepared.append(self._stage_int8(tensor))
                                pooled.append(True)
                            elif src_dtype != want:
                                prepared.append(self.pool.stage(tensor, torch.float32))
                                pooled.append(True)
                            else:
                                out = self.transport.transfer(tensor)
                                prepared.append(out)
                                pooled.append(out is not tensor)
                        if self.stream is not None:
                            # the staging work, not the enqueue, lands in quant_s
                            done = torch.cuda.Event()
                            done.record(self.stream)
                            done.synchronize()
                except Exception as e:  # fail the request, not the thread
                    err = self._wrap_error(payload, "input staging", e)
                quant_t = self.clock.now() - t0
                self._exec_queue.put((payload, prepared, pooled, quant_t, err))

    # -- execution thread -----------------------------------------------------
    def _exec_loop(self) -> None:
        with self._on_stream():
            while True:
                item = self._exec_queue.get()
                if item is None:
                    return
                payload, prepared, pooled, quant_t, err = item
                t0 = self.clock.now()
                payload["started"] = t0
                if self.on_start is not None:
                    self.on_start(payload)
                out = None
                if err is None:
                    try:
                        # the engine lookup lives *inside* the try: an unknown
                        # backend key must fail the request, not kill this
                        # thread and strand the coordinator
                        engine: Engine = self.engines[payload["backend"]]
                        out = engine.execute(payload["engine_key"],
                                             prepared if prepared else None)
                    except Exception as e:  # surface, don't kill the worker
                        err = self._wrap_error(payload, "execution", e)
                exec_t = self.clock.now() - t0
                if err is not None and self.stream is not None:
                    self.stream.synchronize()   # failed work may still read its inputs
                # staged input buffers are consumed by the engine call, whose
                # stream was synchronised: return them to the pool (the
                # Tensor Pool recycling path, §5.3)
                for arr, from_pool in zip(prepared, pooled):
                    if from_pool:
                        self.pool.release(arr)
                self.busy_time += exec_t + quant_t
                self.tasks_done += 1
                payload["quant_s"] = quant_t
                payload["exec_s"] = exec_t
                self.on_done(payload, out if err is None else err, quant_t, exec_t)
