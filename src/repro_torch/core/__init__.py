"""Puzzle core in the port: the paper's contribution — GA-based multi-model
scheduling.

Each module is a copy of its ``repro.core`` counterpart, held to it by the
parity tests (``tests/test_torch_zoo.py``, ``test_torch_sim.py``,
``test_torch_search.py``, ``test_torch_analyzer.py``); the profiler's
executing backend and the analyzer's device-in-the-loop rounds run on the
card, and so does the compiled batch tier (``run_batch_compiled``, an
event-loop kernel written for the H100, held to the numpy tier within
``COMPILED_*``). Left out until slice 6d (ROADMAP): ``TPU_COMM_MODEL``,
``tpu_lanes`` and ``LaneRooflineBackend``; the reference's
``JaxExecBackend`` is :class:`TorchExecBackend` here.
"""
from .analyzer import AnalyzerConfig, StaticAnalyzer
from .arrivals import (
    ARRIVAL_KINDS,
    ArrivalSpec,
    arrival_horizon,
    draw_arrivals,
)
from .baselines import best_mapping_solutions, npu_only_solution
from .batchsim import (
    SHARD_MIN_LANES,
    BatchLane,
    BatchResult,
    BatchSimulator,
    batch_objectives,
    run_batch,
)
from .batchsim_compiled import (
    COMPILED_ABS_TOL,
    COMPILED_REL_TOL,
    run_batch_compiled,
)
from .chromosome import (
    BACKENDS,
    DTYPES,
    PlacedSubgraph,
    Solution,
    SolutionFactory,
    decode_solution,
    subgraph_processor,
    upmx,
)
from .comm import (
    PAPER_COMM_MODEL,
    PiecewiseLinearCommModel,
    microbenchmark_host,
    quantization_cost,
)
from .des import Environment, PriorityStore
from .fastsim import FastSimSpec, FastSimulator, SpecBuilder, build_spec
from .faults import NO_FAULTS, FaultSpec, FaultStream
from .ga import GAConfig, GAResult, GeneticScheduler
from .graph import Edge, Layer, ModelGraph, Subgraph, branching_graph, chain_graph
from .memlayout import CHUNK, rounded_chunk_bytes
from .nsga import crowding_distance, das_dennis, dominates, fast_non_dominated_sort, nsga3_select
from .processors import Processor, mobile_processors
from .profiler import (
    AnalyticMobileBackend,
    ProfileDB,
    Profiler,
    TableBackend,
    TorchExecBackend,
    fragmentation_penalty,
)
from .scenarios import (
    Scenario,
    base_periods,
    best_model_times,
    build_scenario,
    random_scenarios,
    sample_groups,
    whole_model_placement,
)
from .scoring import (
    SaturationResult,
    absolute_deadlines,
    bisect_alpha_probes,
    deadline_satisfaction,
    group_scores,
    percentile,
    qoe_score,
    rt_score,
    saturation_multiplier,
    saturation_multiplier_bisect,
    scenario_score,
)
from .simulator import (
    NoiseModel,
    RequestRecord,
    RuntimeSimulator,
    SimResult,
    TaskRecord,
    derive_dependencies,
    subgraph_task_costs,
)

__all__ = [k for k in dir() if not k.startswith("_")]
