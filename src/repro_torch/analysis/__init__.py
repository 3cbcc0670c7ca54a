"""Static schedule analysis (``schedlint``): decode-time feasibility checks.

This package verifies candidate schedules *without simulating them*:
structural lints over the contracted subgraph DAG, capability checks
against the processor descriptors, chunk-rounded memory-residency bounds
against TensorPool capacities, and deadline lower bounds (critical path,
per-processor work) that can prove a ``(solution, α)`` pair unsatisfiable
from ProfileDB costs alone.

Soundness contract: every *error*-severity finding with ``proof=True`` is
a guarantee — the simulator could never score the flagged chromosome
feasible. That is what allows the GA pre-screen (``GAConfig.prescreen``)
and the α-probe skip (``bisect_alpha_probes(skip_below=...)``) to act on
findings without changing search results. Warnings (e.g. capability
fallbacks) carry no such guarantee and never prune.

Port of ``repro.analysis``. CLI: ``python -m repro_torch.analysis.lint --help``.
"""
from .diagnostics import CODES, Diagnostic, LintReport
from .schedlint import (
    PROOF_MARGIN,
    ScheduleLinter,
    memory_lower_bounds,
    provision_memory,
    structural_diagnostics,
)

__all__ = [
    "CODES",
    "Diagnostic",
    "LintReport",
    "PROOF_MARGIN",
    "ScheduleLinter",
    "memory_lower_bounds",
    "provision_memory",
    "structural_diagnostics",
]
