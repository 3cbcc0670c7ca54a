"""Genetic Algorithm loop (paper §4.3, Fig. 8).

Follows the paper's process: all candidates become parents (no elitist
subset selection), one-point crossover on partition/mapping, UPMX on
priority, mutation, probabilistic local search (merge-neighbors and
reposition-adjacent-layers), fast simulator evaluation during search,
accurate ("brief on-target execution") evaluation before the Pareto
update, NSGA-III replacement, convergence after ``patience`` generations
without average-score improvement.

Copy of ``repro.core.ga``, verbatim in its arithmetic (the same
``random.Random`` draws in the same order).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .chromosome import Solution, SolutionFactory
from .nsga import fast_non_dominated_sort, nsga3_select

Objective = Tuple[float, ...]
EvalFn = Callable[[Solution], Objective]
# batch evaluator: (solutions, accurate) -> objectives, one per solution
BatchEvalFn = Callable[[Sequence[Solution], bool], List[Objective]]
# static pre-screen: worst-rank objective for a *provably* infeasible
# chromosome (simulating it could never beat any feasible candidate),
# or None when the analyzer cannot prove anything — the sound default.
PrescreenFn = Callable[[Solution], Optional[Objective]]


@dataclass
class GAConfig:
    pop_size: int = 24
    max_generations: int = 60
    patience: int = 3            # paper: stop after 3 non-improving generations
    min_generations: int = 12    # don't let a converged seed stop the search cold
    cx_prob: float = 0.9
    p_local: float = 0.5
    p_bit: float = 0.05
    p_map: float = 0.08
    p_prio: float = 0.2
    p_cfg: float = 0.1
    seed: int = 0
    # Every N generations, re-evaluate the population's best candidate through
    # the reference oracle (RuntimeSimulator) and record the drift vs the fast
    # engine. 0 disables the check.
    oracle_interval: int = 0
    # False selects the pure-Python NSGA reference implementations (the seed
    # code path, kept for differential testing and seed-path benchmarking).
    vectorized_nsga: bool = True
    # Route whole-generation evaluations (offspring fast evals + front-0
    # accurate re-evals) through the scheduler's batch evaluator instead of
    # the per-child loop. True selects the numpy lock-step engine: fitness
    # values are identical either way (it is bit-exact; enforced by
    # tests/test_ga_determinism.py); only wall-clock and the evaluation
    # counter's cache interleaving differ. The string "compiled" selects
    # the reference's compiled batch core, which comes with slice 6c and
    # raises until then.
    batch_eval: "bool | str" = False
    # Route every chromosome through the static analyzer
    # (repro_torch.analysis.schedlint) before objectives(): proven-infeasible
    # candidates get worst-rank fitness without a single simulated event.
    # Sound-only by contract — the analyzer may only flag chromosomes the
    # simulator could never score feasible (structural corruption, memory
    # capacity violations), so with pruning off the search trajectory is
    # bit-identical whenever nothing would have been pruned (enforced by
    # tests/test_schedlint.py).
    prescreen: bool = False
    # Device-in-the-loop feedback (paper §4.2/§5): every N generations the
    # scheduler hands the current Pareto front to ``measure_device``, which
    # executes candidates on the real runtime, writes measured per-subgraph
    # timings back into the ProfileDB and invalidates the evaluation caches
    # (StaticAnalyzer.apply_measured_costs). When measurements changed any
    # profile entry, the fitness memo is flushed and the whole population is
    # re-evaluated — the search continues on measured costs. 0 disables.
    device_in_loop_interval: int = 0


@dataclass
class GAResult:
    pareto: List[Solution]
    history: List[float]           # average population score per generation
    generations: int
    evaluations: int
    oracle_drift: List[Tuple[int, float]] = field(default_factory=list)
    # (generation, changed-profile-entry count) per device-in-the-loop
    # measurement round that actually updated the ProfileDB
    device_updates: List[Tuple[int, int]] = field(default_factory=list)
    # static pre-screen counters: chromosomes checked, pruned as proven
    # infeasible, and the simulator calls those prunes avoided
    prescreen_stats: Dict[str, int] = field(default_factory=dict)


def _dominates(a: Objective, b: Objective) -> bool:
    return all(x <= y for x, y in zip(a, b)) and any(x < y for x, y in zip(a, b))


class GeneticScheduler:
    def __init__(
        self,
        factory: SolutionFactory,
        evaluate_fast: EvalFn,
        evaluate_accurate: Optional[EvalFn] = None,
        config: Optional[GAConfig] = None,
        evaluate_oracle: Optional[EvalFn] = None,
        evaluate_batch: Optional[BatchEvalFn] = None,
        measure_device: Optional[Callable[[Sequence[Solution]], int]] = None,
        prescreen: Optional[PrescreenFn] = None,
    ):
        self.factory = factory
        self.evaluate_fast = evaluate_fast
        self.evaluate_accurate = evaluate_accurate or evaluate_fast
        self.evaluate_oracle = evaluate_oracle
        self.evaluate_batch = evaluate_batch
        self.measure_device = measure_device
        self.cfg = config or GAConfig()
        self.prescreen = prescreen if self.cfg.prescreen else None
        self.prescreen_stats: Dict[str, int] = {
            "checked": 0, "pruned": 0, "simulations_avoided": 0}
        self.rng = random.Random(self.cfg.seed)
        self.evaluations = 0
        self._cache: Dict[Tuple, Objective] = {}

    # -- evaluation with memoization ------------------------------------------
    def _prescreen(self, sol: Solution) -> Optional[Objective]:
        """Static verdict for ``sol``: a worst-rank objective when the
        analyzer proves infeasibility, else None (simulate normally).

        Never touches ``self.rng``, so with no prunes the search trajectory
        is bit-identical to a prescreen-off run.
        """
        if self.prescreen is None:
            return None
        self.prescreen_stats["checked"] += 1
        obj = self.prescreen(sol)
        if obj is not None:
            self.prescreen_stats["pruned"] += 1
            self.prescreen_stats["simulations_avoided"] += 1
        return obj

    def _eval(self, sol: Solution, accurate: bool = False) -> Objective:
        key = (sol.key(), accurate)
        if key in self._cache:
            return self._cache[key]
        obj = self._prescreen(sol)
        if obj is None:
            fn = self.evaluate_accurate if accurate else self.evaluate_fast
            obj = fn(sol)
            self.evaluations += 1
        self._cache[key] = obj
        return obj

    def _eval_generation(
        self, sols: Sequence[Solution], accurate: bool = False
    ) -> List[Objective]:
        """Evaluate a whole generation, batched when configured.

        Memoization and the evaluation counter behave like per-child
        :meth:`_eval` calls; the batch evaluator additionally dedups by
        decoded content downstream. Falls back to the per-child loop when no
        batch evaluator is wired or ``cfg.batch_eval`` is off.
        """
        if not (self.cfg.batch_eval and self.evaluate_batch is not None):
            return [self._eval(s, accurate) for s in sols]
        missing: List[Solution] = []
        seen = set()
        for s in sols:
            key = (s.key(), accurate)
            if key not in self._cache and key not in seen:
                seen.add(key)
                pruned = self._prescreen(s)
                if pruned is not None:
                    self._cache[key] = pruned
                else:
                    missing.append(s)
        if missing:
            objs = self.evaluate_batch(missing, accurate)
            for s, obj in zip(missing, objs):
                self._cache[(s.key(), accurate)] = obj
                self.evaluations += 1
        return [self._cache[(s.key(), accurate)] for s in sols]

    # -- local search (paper §4.3) ---------------------------------------------
    def _local_merge(self, sol: Solution) -> Solution:
        """Merge neighboring subgraphs: clear one cut bit; keep if dominating."""
        cuts = [
            (net, i)
            for net in range(len(sol.partition))
            for i, b in enumerate(sol.partition[net])
            if b
        ]
        if not cuts:
            return sol
        net, i = self.rng.choice(cuts)
        cand = sol.copy()
        cand.fitness = None
        cand.partition[net][i] = 0
        base = sol.fitness or self._eval(sol)
        obj = self._eval(cand)
        if _dominates(obj, base) or obj == base:
            cand.fitness = obj
            return cand
        return sol

    def _local_reposition(self, sol: Solution) -> Solution:
        """Reposition adjacent layers: pull one layer onto a neighbor's processor."""
        nets = [n for n in range(len(sol.mapping)) if len(sol.mapping[n]) > 1]
        if not nets:
            return sol
        net = self.rng.choice(nets)
        i = self.rng.randrange(len(sol.mapping[net]) - 1)
        cand = sol.copy()
        cand.fitness = None
        if self.rng.random() < 0.5:
            cand.mapping[net][i + 1] = cand.mapping[net][i]
        else:
            cand.mapping[net][i] = cand.mapping[net][i + 1]
        base = sol.fitness or self._eval(sol)
        obj = self._eval(cand)
        if _dominates(obj, base):
            cand.fitness = obj
            return cand
        return sol

    # -- mating ----------------------------------------------------------------
    def _mate(self, parents: Sequence[Solution]) -> List[Solution]:
        """Pair the (already shuffled) parents and produce offspring.

        Adjacent parents mate pairwise. An odd population leaves one
        shuffled parent over; it mates a uniformly drawn partner from the
        rest (itself when the population is a singleton) instead of
        silently sitting the generation out — ``zip(parents[0::2],
        parents[1::2])`` alone drops the last parent from mating every
        generation. Even populations consume exactly the same RNG stream
        as before the fix (the extra draw happens only on the odd path).
        """
        cfg = self.cfg
        pairs = list(zip(parents[0::2], parents[1::2]))
        if len(parents) % 2:
            leftover = parents[-1]
            partner = (parents[self.rng.randrange(len(parents) - 1)]
                       if len(parents) > 1 else leftover)
            pairs.append((leftover, partner))
        offspring: List[Solution] = []
        for a, b in pairs:
            if self.rng.random() < cfg.cx_prob:
                c1, c2 = self.factory.crossover(a, b)
            else:
                c1, c2 = a.copy(), b.copy()
            c1 = self.factory.mutate(c1, cfg.p_bit, cfg.p_map, cfg.p_prio, cfg.p_cfg)
            c2 = self.factory.mutate(c2, cfg.p_bit, cfg.p_map, cfg.p_prio, cfg.p_cfg)
            offspring.extend([c1, c2])
        return offspring

    # -- main loop ------------------------------------------------------------
    def run(self, seeds: Sequence[Solution] = ()) -> GAResult:
        cfg = self.cfg
        pop: List[Solution] = [s.copy() for s in seeds]
        while len(pop) < cfg.pop_size:
            pop.append(self.factory.random_solution())
        pop = pop[: cfg.pop_size]
        for s, obj in zip(pop, self._eval_generation(pop)):
            s.fitness = obj

        history: List[float] = []
        oracle_drift: List[Tuple[int, float]] = []
        device_updates: List[Tuple[int, int]] = []
        stale = 0
        best_avg = float("inf")
        gen = 0
        for gen in range(1, cfg.max_generations + 1):
            # All candidates are parents (paper: avoid premature convergence).
            parents = pop[:]
            self.rng.shuffle(parents)
            offspring = self._mate(parents)
            # whole-generation fast evaluation (batched when configured),
            # then the probabilistic local search pass per child
            for child, obj in zip(offspring, self._eval_generation(offspring)):
                child.fitness = obj
            for k, child in enumerate(offspring):
                if self.rng.random() < cfg.p_local:
                    child = self._local_merge(child)
                    child = self._local_reposition(child)
                    offspring[k] = child
            # Accurate ("brief on-target") evaluation of the candidates that
            # could enter the Pareto set, before the population update.
            combined = pop + offspring
            fits = [list(s.fitness) for s in combined]
            front0 = fast_non_dominated_sort(fits, vectorized=cfg.vectorized_nsga)[0]
            front0_objs = self._eval_generation(
                [combined[ix] for ix in front0], accurate=True)
            for ix, obj in zip(front0, front0_objs):
                combined[ix].fitness = obj
            fits = [list(s.fitness) for s in combined]
            keep = nsga3_select(fits, cfg.pop_size, rng=self.rng,
                                vectorized=cfg.vectorized_nsga)
            pop = [combined[i] for i in keep]

            if (
                self.measure_device is not None
                and cfg.device_in_loop_interval > 0
                and gen % cfg.device_in_loop_interval == 0
            ):
                # brief on-target execution of the Pareto candidates: feed
                # measured costs back, then re-rank everything on them
                fits = [list(s.fitness) for s in pop]
                front0 = fast_non_dominated_sort(
                    fits, vectorized=cfg.vectorized_nsga)[0]
                changed = self.measure_device([pop[i] for i in front0])
                if changed:
                    device_updates.append((gen, changed))
                    self._cache.clear()
                    for s, obj in zip(pop, self._eval_generation(pop)):
                        s.fitness = obj
            avg = sum(sum(s.fitness) for s in pop) / len(pop)
            history.append(avg)
            if (
                self.evaluate_oracle is not None
                and cfg.oracle_interval > 0
                and gen % cfg.oracle_interval == 0
            ):
                # reference-oracle spot check: the fast engine is exact, so
                # any drift on the best candidate flags a parity regression.
                best = min(pop, key=lambda s: sum(s.fitness))
                ref = self.evaluate_oracle(best)
                fast = self._eval(best)
                drift = max(
                    abs(a - b) for a, b in zip(ref, fast)
                ) if ref and fast else 0.0
                oracle_drift.append((gen, drift))
            if avg < best_avg - 1e-12:
                best_avg = avg
                stale = 0
            else:
                stale += 1
            if stale >= cfg.patience and gen >= cfg.min_generations:
                break

        fits = [list(s.fitness) for s in pop]
        pareto_ix = fast_non_dominated_sort(fits, vectorized=cfg.vectorized_nsga)[0]
        # dedupe identical chromosomes
        seen = set()
        pareto: List[Solution] = []
        for i in pareto_ix:
            k = pop[i].key()
            if k not in seen:
                seen.add(k)
                pareto.append(pop[i])
        return GAResult(
            pareto=pareto, history=history, generations=gen,
            evaluations=self.evaluations, oracle_drift=oracle_drift,
            device_updates=device_updates,
            prescreen_stats=dict(self.prescreen_stats),
        )
