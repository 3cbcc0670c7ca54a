"""Scenario specifications for the randomized sweep (paper §6.1).

A :class:`ScenarioSpec` is the *replayable identity* of one randomly
generated scenario: which models, grouped how, under which request
*arrival process* (periodic / jittered / Poisson — the sweep's arrival
axis), plus the integer seeds the evaluation's explicitly seeded stages
(GA stream, baseline hillclimb shuffle, satisfaction-rate noise, arrival
timestamps) derive from. Specs serialize to/from plain JSON dicts so a
sweep run directory is self-describing and resumable — re-running a sweep
with the same ``(count, seed, size bounds, arrival)`` regenerates
byte-identical specs, and the harness cross-checks stored results against
the regenerated spec before reusing them.

Seed derivation is SHA-256 based (not ``hash()``) so it is stable across
processes and interpreter runs regardless of ``PYTHONHASHSEED`` — the
property that makes ``--workers N`` output identical to ``--workers 1``.
"""
from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.arrivals import ArrivalSpec
from ..core.faults import FaultSpec
from ..core.scenarios import sample_groups
from ..zoo import MODEL_NAMES


def scenario_stream_seed(sweep_seed: int, index: int) -> int:
    """Deterministic 63-bit per-scenario seed from (sweep seed, index).

    Each scenario gets its own independent RNG stream: drawing scenario *i*
    never consumes randomness from scenario *j*, so scenarios can be
    generated, re-generated, or evaluated in any order (and on any worker)
    with identical results.
    """
    digest = hashlib.sha256(f"puzzle-sweep/{sweep_seed}/{index}".encode()).digest()
    return int.from_bytes(digest[:8], "big") >> 1


def arrival_stream_seed(sweep_seed: int, index: int) -> int:
    """Deterministic 63-bit per-scenario *arrival* seed.

    Separate derivation domain from :func:`scenario_stream_seed` so the
    arrival timestamps of scenario *i* are independent of its composition
    draws — and, like them, SHA-256-based so the value is a constant of
    ``(sweep_seed, index)`` across processes, worker counts and
    ``PYTHONHASHSEED``.
    """
    digest = hashlib.sha256(
        f"puzzle-arrival/{sweep_seed}/{index}".encode()).digest()
    return int.from_bytes(digest[:8], "big") >> 1


def fault_stream_seed(sweep_seed: int, index: int) -> int:
    """Deterministic 63-bit per-scenario *fault* seed.

    Third derivation domain beside :func:`scenario_stream_seed` and
    :func:`arrival_stream_seed`: the straggler draws of scenario *i*'s
    fault ensemble are independent of its composition and arrival streams,
    and stable across processes and ``PYTHONHASHSEED``.
    """
    digest = hashlib.sha256(
        f"puzzle-fault/{sweep_seed}/{index}".encode()).digest()
    return int.from_bytes(digest[:8], "big") >> 1


@dataclass(frozen=True)
class ScenarioSpec:
    """One randomized scenario: identity, composition, RNG stream, arrivals.

    ``groups`` holds per-group tuples of model names from the nine-network
    zoo (duplicates across groups allowed; materialized as distinct graphs).
    ``seed`` is the scenario's private stream seed — the seeded evaluation
    stages derive from it, never from global RNG state. ``arrival`` is the
    scenario's request arrival process (``None`` = periodic, serialized by
    omission so pre-arrival-axis run dirs still load); non-periodic specs
    carry their own SHA-256-derived arrival seed
    (:func:`arrival_stream_seed`), keeping results worker-count-invariant
    and resumable exactly like the composition stream. ``faults`` is the
    scenario's injected fault ensemble (``None`` = clean, serialized by
    omission); its straggler stream seed is the SHA-256-derived
    :func:`fault_stream_seed`, so the faulted sweep keeps the same
    determinism contract as the clean one.
    """

    index: int
    name: str
    seed: int
    groups: Tuple[Tuple[str, ...], ...]
    arrival: Optional[ArrivalSpec] = None
    faults: Optional[FaultSpec] = None

    @property
    def num_models(self) -> int:
        return sum(len(g) for g in self.groups)

    def to_json(self) -> Dict[str, object]:
        """Plain-JSON dict (lists instead of tuples); inverse of :meth:`from_json`."""
        doc: Dict[str, object] = {
            "index": self.index,
            "name": self.name,
            "seed": self.seed,
            "groups": [list(g) for g in self.groups],
        }
        if self.arrival is not None:
            doc["arrival"] = self.arrival.to_json()
        if self.faults is not None:
            doc["faults"] = self.faults.to_json()
        return doc

    @classmethod
    def from_json(cls, d: Dict[str, object]) -> "ScenarioSpec":
        return cls(
            index=int(d["index"]),
            name=str(d["name"]),
            seed=int(d["seed"]),
            groups=tuple(tuple(g) for g in d["groups"]),
            arrival=(ArrivalSpec.from_json(d["arrival"])
                     if d.get("arrival") is not None else None),
            faults=(FaultSpec.from_json(d["faults"])
                    if d.get("faults") is not None else None),
        )


def generate_scenario_specs(
    count: int,
    seed: int = 0,
    model_names: Sequence[str] = MODEL_NAMES,
    min_groups: int = 1,
    max_groups: int = 3,
    min_models: int = 1,
    max_models: int = 4,
    arrival: Optional[str] = None,
    arrival_jitter: float = 0.25,
    arrival_distribution: str = "uniform",
    faults: Optional[str] = None,
    fault_straggler_prob: float = 0.1,
    fault_straggler_shape: float = 1.5,
    fault_dropout: Optional[Tuple[int, float, Optional[float]]] = (2, 0.02, 0.05),
    fault_throttle: Optional[Tuple[int, float, float, float]] = (0, 0.01, 0.03, 2.0),
) -> List[ScenarioSpec]:
    """Generate ``count`` randomized scenario specs per the §6.1 recipe.

    For each scenario: 1–3 model groups (uniform), 1–4 distinct models per
    group (uniform) sampled from ``model_names`` — bounds adjustable via the
    keyword arguments. Scenario *i* is drawn from its own
    ``random.Random(scenario_stream_seed(seed, i))`` stream, so the list is
    a pure function of the arguments and any prefix of it is stable under a
    larger ``count``.

    ``arrival`` opens the sweep's arrival axis: ``None``/"periodic" keeps
    the paper's periodic sources (and byte-identical spec JSON), while
    "jittered" / "poisson" attach an :class:`ArrivalSpec` of that kind with
    a per-scenario :func:`arrival_stream_seed` — the compositions stay
    identical to the periodic sweep at the same ``seed``, only the traffic
    changes. ``arrival_jitter``/``arrival_distribution`` parameterize the
    jittered process.

    ``faults`` opens the fault axis the same way: ``None``/"none" keeps
    clean scenarios (byte-identical spec JSON), "stragglers" attaches a
    heavy-tailed straggler-only :class:`FaultSpec`, and "mixed" adds the
    ``fault_dropout`` window (``(pid, t0, t1)`` seconds; ``t1=None`` =
    permanent) and ``fault_throttle`` window (``(pid, t0, t1, factor)``) on
    top. Window times are absolute seconds shared across scenarios —
    deliberate, so the ensemble is identical per scenario and differences
    in damage reflect the *schedule*; only the straggler draws vary, via
    the per-scenario :func:`fault_stream_seed`. A scenario spec carrying
    faults makes the whole evaluation pipeline (GA search, α*-search,
    satisfaction) run under that ensemble — the robustness objective.
    """
    specs: List[ScenarioSpec] = []
    for i in range(count):
        stream = scenario_stream_seed(seed, i)
        rng = random.Random(stream)
        groups = sample_groups(
            rng, model_names,
            min_groups=min_groups, max_groups=max_groups,
            min_models=min_models, max_models=max_models,
        )
        arrival_spec = None
        if arrival is not None and arrival != "periodic":
            arrival_spec = ArrivalSpec(
                kind=arrival, jitter=arrival_jitter,
                distribution=arrival_distribution,
                seed=arrival_stream_seed(seed, i),
            )
        fault_spec = None
        if faults is not None and faults != "none":
            if faults not in ("stragglers", "mixed"):
                raise ValueError(f"unknown fault mode {faults!r} "
                                 f"(expected none/stragglers/mixed)")
            dropouts = ()
            throttles = ()
            if faults == "mixed":
                if fault_dropout is not None:
                    dropouts = (tuple(fault_dropout),)
                if fault_throttle is not None:
                    throttles = (tuple(fault_throttle),)
            fault_spec = FaultSpec(
                dropouts=dropouts, throttles=throttles,
                straggler_prob=fault_straggler_prob,
                straggler_shape=fault_straggler_shape,
                seed=fault_stream_seed(seed, i),
            )
        specs.append(ScenarioSpec(
            index=i, name=f"sweep_s{seed}_{i:03d}", seed=stream,
            groups=tuple(groups), arrival=arrival_spec, faults=fault_spec,
        ))
    return specs
