"""A small deterministic discrete-event simulation engine (SimPy stand-in).

The paper's Static Analyzer uses SimPy to replay runtime behaviour cheaply
(§4.3). SimPy is not installed in this offline environment, so this module
implements the subset we need with matching semantics:

* :class:`Environment` — binary-heap event loop with ``now``/``run``;
* :class:`Process` — generator coroutines that ``yield`` events;
* :meth:`Environment.timeout` — delay events;
* :class:`PriorityStore` — a put/get queue delivering lowest-priority-key
  items first (workers pull tasks from these).

Determinism: ties in time are broken by a monotonically increasing sequence
number, so a given seed always produces the same trace.

This engine backs the *reference* simulator (:class:`RuntimeSimulator`).
The GA search hot path uses :mod:`repro_torch.core.fastsim`, an array-based event
loop with identical semantics but no Event/Process object churn; the two are
kept in lock-step by the parity tests in ``tests/test_fastsim.py``.

Copy of ``repro.core.des``, verbatim.
"""
from __future__ import annotations

import heapq
from typing import Any, Callable, Generator, List, Optional, Tuple


class Event:
    """A one-shot event; callbacks fire when it triggers."""

    __slots__ = ("env", "callbacks", "triggered", "value")

    def __init__(self, env: "Environment"):
        self.env = env
        self.callbacks: List[Callable[["Event"], None]] = []
        self.triggered = False
        self.value: Any = None

    def succeed(self, value: Any = None) -> "Event":
        if self.triggered:
            raise RuntimeError("event already triggered")
        self.triggered = True
        self.value = value
        self.env._schedule(self, 0.0)
        return self


class Timeout(Event):
    __slots__ = ()

    def __init__(self, env: "Environment", delay: float, value: Any = None):
        super().__init__(env)
        if delay < 0:
            raise ValueError("negative delay")
        self.triggered = True
        self.value = value
        env._schedule(self, delay)


class Process(Event):
    """Drives a generator; the process event triggers when the generator ends."""

    __slots__ = ("_gen",)

    def __init__(self, env: "Environment", gen: Generator[Event, Any, Any]):
        super().__init__(env)
        self._gen = gen
        init = Event(env)
        init.succeed()
        init.callbacks.append(self._resume)

    def _resume(self, trigger: Event) -> None:
        try:
            target = self._gen.send(trigger.value)
        except StopIteration as stop:
            if not self.triggered:
                self.succeed(getattr(stop, "value", None))
            return
        if not isinstance(target, Event):
            raise TypeError(f"process yielded non-event {target!r}")
        target.callbacks.append(self._resume)


class Environment:
    """Event loop. Times are floats (seconds in our simulators)."""

    def __init__(self) -> None:
        self.now: float = 0.0
        self._heap: List[Tuple[float, int, Event]] = []
        self._seq = 0

    def _schedule(self, event: Event, delay: float) -> None:
        heapq.heappush(self._heap, (self.now + delay, self._seq, event))
        self._seq += 1

    def timeout(self, delay: float, value: Any = None) -> Timeout:
        return Timeout(self, delay, value)

    def event(self) -> Event:
        return Event(self)

    def process(self, gen: Generator[Event, Any, Any]) -> Process:
        return Process(self, gen)

    def run(self, until: Optional[float] = None) -> None:
        while self._heap:
            t, _, ev = self._heap[0]
            if until is not None and t > until:
                self.now = until
                return
            heapq.heappop(self._heap)
            self.now = t
            # fire callbacks registered at pop time; callbacks appended while
            # firing belong to future triggers of other events.
            callbacks, ev.callbacks = ev.callbacks, []
            for cb in callbacks:
                cb(ev)
        if until is not None:
            self.now = max(self.now, until)


class PriorityStore:
    """FIFO-within-priority item store with blocking ``get``."""

    def __init__(self, env: Environment):
        self.env = env
        self._items: List[Tuple[Any, int, Any]] = []  # (prio_key, seq, item)
        self._seq = 0
        self._getters: List[Event] = []

    def put(self, item: Any, priority: Any = 0) -> None:
        heapq.heappush(self._items, (priority, self._seq, item))
        self._seq += 1
        if self._getters:
            getter = self._getters.pop(0)
            _, _, it = heapq.heappop(self._items)
            getter.succeed(it)

    def get(self) -> Event:
        ev = Event(self.env)
        if self._items:
            _, _, it = heapq.heappop(self._items)
            ev.succeed(it)
        else:
            self._getters.append(ev)
        return ev

    def __len__(self) -> int:
        return len(self._items)
