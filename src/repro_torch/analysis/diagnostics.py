"""Typed diagnostics for the static schedule analyzer.

Every finding is a :class:`Diagnostic` with a stable ``SL0xx`` code, a
severity, a human-readable message and a structured location, collected
into a JSON-serializable :class:`LintReport`. Codes are append-only: a
code's meaning never changes once released, so downstream tooling (the CI
soundness gate, the sweep harness's per-scenario stats) can filter on them
across repo versions.

Copy of ``repro.analysis.diagnostics``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

ERROR = "error"
WARNING = "warning"
SEVERITIES: Tuple[str, ...] = (ERROR, WARNING)

#: Stable diagnostic registry. Structural codes are SL00x, capability SL01x,
#: memory SL02x, deadline SL03x.
CODES: Dict[str, str] = {
    "SL001": "contracted subgraph quotient graph has a dependency cycle",
    "SL002": "dangling cross-subgraph edge or corrupted layer ownership",
    "SL003": "chromosome shape or gene range is invalid for the scenario",
    "SL004": "priority chromosome is not a permutation of the networks",
    "SL010": "(dtype, backend) unsupported on the mapped processor "
             "(simulates via the fallback penalty — not infeasible)",
    "SL020": "per-processor peak tensor residency exceeds memory capacity",
    "SL030": "critical-path/serialization lower bound proves every request "
             "of a group misses its deadline at the probed α",
    "SL031": "per-processor work exceeds the feasible arrival window at "
             "the probed α (utilization bound)",
}


@dataclass(frozen=True)
class Diagnostic:
    """One finding of the static analyzer.

    ``location`` is a tuple of ``(key, value)`` pairs (kept hashable so
    diagnostics deduplicate in sets) — typical keys: ``net``, ``subgraph``,
    ``processor``, ``group``, ``alpha``. ``proof=True`` marks the finding
    as participating in an infeasibility *proof*: the soundness contract
    guarantees the simulator cannot score the schedule feasible. Only
    proof-bearing errors may prune (GA pre-screen, α-probe skip).
    """

    code: str
    severity: str
    message: str
    location: Tuple[Tuple[str, object], ...] = ()
    proof: bool = False

    def __post_init__(self) -> None:
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}")
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def where(self) -> Dict[str, object]:
        """``location`` as a plain dict."""
        return dict(self.location)

    def to_json(self) -> Dict[str, object]:
        return {
            "code": self.code,
            "severity": self.severity,
            "message": self.message,
            "location": dict(self.location),
            "proof": self.proof,
        }

    @classmethod
    def from_json(cls, d: Mapping[str, object]) -> "Diagnostic":
        loc = d.get("location") or {}
        return cls(
            code=str(d["code"]),
            severity=str(d["severity"]),
            message=str(d["message"]),
            location=tuple(sorted(loc.items())),  # type: ignore[union-attr]
            proof=bool(d.get("proof", False)),
        )


@dataclass
class LintReport:
    """All findings for one linted schedule (or one ``(schedule, α)`` pair).

    ``alpha_lower_bound`` is the proven deadline bound: for every
    ``α < alpha_lower_bound`` the scenario score is guaranteed below the
    saturation threshold (0.0 when nothing could be proven — e.g. too many
    groups for the proof template, or no deadline data). ``checked_alpha``
    records the α the deadline lints (SL030/SL031) were evaluated at, when
    one was supplied.
    """

    findings: List[Diagnostic] = field(default_factory=list)
    alpha_lower_bound: float = 0.0
    checked_alpha: Optional[float] = None

    @property
    def infeasible(self) -> bool:
        """True iff the report *proves* the schedule can never be feasible
        (independent of α). Only proof-bearing errors count — warnings and
        α-specific deadline findings (which carry ``alpha`` in their
        location) do not make the schedule itself infeasible."""
        return any(
            d.proof and d.severity == ERROR and "alpha" not in d.where()
            for d in self.findings
        )

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.findings if d.severity == ERROR]

    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.findings if d.severity == WARNING]

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.findings if d.code == code]

    def counts(self) -> Dict[str, int]:
        """Finding count per diagnostic code (stable sort order)."""
        out: Dict[str, int] = {}
        for d in self.findings:
            out[d.code] = out.get(d.code, 0) + 1
        return dict(sorted(out.items()))

    def extend(self, diagnostics: List[Diagnostic]) -> None:
        self.findings.extend(diagnostics)

    def to_json(self) -> Dict[str, object]:
        doc: Dict[str, object] = {
            "findings": [d.to_json() for d in self.findings],
            "alpha_lower_bound": self.alpha_lower_bound,
            "infeasible": self.infeasible,
            "counts": self.counts(),
        }
        if self.checked_alpha is not None:
            doc["checked_alpha"] = self.checked_alpha
        return doc

    @classmethod
    def from_json(cls, d: Mapping[str, object]) -> "LintReport":
        rep = cls(
            findings=[Diagnostic.from_json(f)  # type: ignore[arg-type]
                      for f in d.get("findings", ())],
            alpha_lower_bound=float(d.get("alpha_lower_bound", 0.0)),
        )
        if "checked_alpha" in d:
            rep.checked_alpha = float(d["checked_alpha"])  # type: ignore[arg-type]
        return rep
